"""One rank of a gloo process group that runs the port's sequence-parallel
entry points for tests/test_torch_ring.py and tests/test_torch_ulysses.py.
It imports only torch, numpy and the port.

    python tests/_torch_sp_worker.py RANK WORLD PORT CASES.npz OUT_DIR [cuda]

CASES.npz holds `cases` (a JSON list of {"name", "kind", "causal",
"dtype"}) and, for each case name, the global (B, T, H, D) fp32 arrays
`<name>/q`, `<name>/k`, `<name>/v`. For each case this rank takes its
sequence shard (rank r: positions r*T/n .. (r+1)*T/n - 1), runs the
entry point named by `kind` forward and backward on sum(out**2) (each
rank's local sum; the collectives' backward joins them into the global
loss), and writes its output and gradient shards in fp32 to
OUT_DIR/rank<r>.npz as `<name>/out`, `<name>/dq`, `<name>/dk`, `<name>/dv`.
The group is gloo on the CPU, or NCCL with one card a rank when the last
argument is "cuda".

`run_group` (for the tests) starts the ranks on a free port and joins
their shards back into global arrays.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distributed_vgg_f_tpu_torch.parallel.distributed import \
    initialize_distributed  # noqa: E402
from distributed_vgg_f_tpu_torch.parallel.ring_attention import \
    ring_self_attention  # noqa: E402
from distributed_vgg_f_tpu_torch.parallel.ring_flash import \
    ring_flash_attention  # noqa: E402
from distributed_vgg_f_tpu_torch.parallel.ulysses import \
    ulysses_self_attention  # noqa: E402

ENTRY = {
    "ring": ring_self_attention,
    "ring_flash": ring_flash_attention,
    "ulysses_einsum": lambda *a, **kw: ulysses_self_attention(
        *a, kernel="einsum", **kw),
    "ulysses_flash": lambda *a, **kw: ulysses_self_attention(
        *a, kernel="flash", **kw),
}


def main(rank: int, world: int, port: int, cases_path: str,
         out_dir: str, device: str = "cpu") -> None:
    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, device=device)
    dev = torch.device(f"cuda:{rank % torch.cuda.device_count()}"
                       if device == "cuda" else "cpu")
    data = np.load(cases_path)
    results = {}
    for case in json.loads(str(data["cases"])):
        name = case["name"]
        dtype = getattr(torch, case["dtype"])
        shards = []
        for key in "qkv":
            x = data[f"{name}/{key}"]
            t_loc = x.shape[1] // world
            shard = torch.from_numpy(
                x[:, rank * t_loc:(rank + 1) * t_loc].copy())
            shards.append(shard.to(dev, dtype).requires_grad_())
        out = ENTRY[case["kind"]](*shards, causal=case["causal"])
        (out.float() ** 2).sum().backward()
        results[f"{name}/out"] = out.detach().float().cpu().numpy()
        for key, x in zip("qkv", shards):
            results[f"{name}/d{key}"] = x.grad.float().cpu().numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_group(world: int, cases: list, arrays: dict, tmp_dir: str,
              timeout: float = 240.0, device: str = "cpu") -> dict:
    """Run `cases` (with their global inputs in `arrays`) in `world`
    processes (gloo on the CPU, or NCCL over `world` cards with
    device="cuda"); returns `<name>/<out|dq|dk|dv>` -> the global fp32
    array."""
    cases_path = os.path.join(tmp_dir, "cases.npz")
    np.savez(cases_path, cases=np.array(json.dumps(cases)), **arrays)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), cases_path, tmp_dir, device], env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"ranks failed {bad}:\n" + "\n".join(logs))
    shards = [np.load(os.path.join(tmp_dir, f"rank{r}.npz"))
              for r in range(world)]
    return {key: np.concatenate([s[key] for s in shards], axis=1)
            for key in shards[0].files}


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5], *sys.argv[6:])
