"""Convert one step of a JAX package checkpoint (Orbax) into the PyTorch
port's checkpoint format, so a port run resumes it through its normal
`Trainer.restore_or_init()`.

    python -m tools.orbax_to_port SRC_DIR DST_DIR [--step N]

The step is restored through the JAX package's own `CheckpointManager`,
so its checksum manifest is verified (default: its newest intact
best/latest step; an explicitly named corrupt step is refused). Its
arrays are written, in the Flax names and layouts, through the port's
`CheckpointManager` into DST_DIR with a manifest:

    params/<layer>/<leaf>      the Flax params, as they are, or
    params                     ZeRO-3's flat (T,) vector
    opt/trace                  optax's momentum trace: the ZeRO (T,) vector,
    opt/trace/<layer>/<leaf>   or one array per parameter
    opt/count                  optax's count (the LR schedule's position)
    step, ema_params/...       the step and the EMA when the run kept one
                               (under ZeRO-3 the (T,) `ema_params`)
    batch_stats/<layer>/<leaf> the BatchNorm statistics (ResNet), and
    ema_batch_stats/...        their EMA

and the step's `extra` (`examples_seen`, the `opt_layout` and
`param_layout` receipts, the iterator blob) is carried over as it is. A
JAX ZeRO-2 or ZeRO-3 state (bucketed or canonical flat) written on any
number of devices then lands on the port's N ranks, in any of the port's
layouts, through its layout migration (checkpoint/retopology.py).

It imports JAX and both packages, so it runs where JAX is installed, not
on the card's host.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Optional

import numpy as np

if __package__ in (None, ""):   # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _walk(tree: Any, path: tuple = ()):
    """(path, leaf) of a restored Orbax tree: nested dicts, lists for
    optax's state tuple."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _walk(value, path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _walk(value, path + (str(i),))
    elif tree is not None:
        yield path, tree


def port_arrays(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A restored JAX TrainState tree (numpy leaves) -> the port's array
    names. Exactly one momentum `trace` and one `count` in the optax
    state; the params and EMA params as a tree or, from a ZeRO-3 run, as
    one flat vector each; the BatchNorm statistics and their EMA as they
    are."""
    out: Dict[str, np.ndarray] = {
        "step": np.asarray(state["step"], np.int32)}
    for prefix in ("params", "ema_params", "batch_stats", "ema_batch_stats"):
        for path, leaf in _walk(state.get(prefix)):
            out["/".join((prefix,) + path)] = np.asarray(leaf)
    for prefix in ("params", "ema_params"):
        if prefix in out and out[prefix].ndim != 1:
            raise ValueError(f"the checkpoint's {prefix} are neither a tree "
                             f"nor a flat vector: shape {out[prefix].shape}")
    if any(k in out for k in ("batch_stats", "ema_batch_stats")):
        raise ValueError("the checkpoint's BatchNorm statistics are not a "
                         "tree")
    traces = [(p, leaf) for p, leaf in _walk(state["opt_state"])
              if "trace" in p]
    counts = [leaf for p, leaf in _walk(state["opt_state"])
              if p and p[-1] == "count"]
    if len(counts) != 1 or not traces:
        raise ValueError(f"expected one momentum trace and one count in the "
                         f"optax state, found {len(traces)} trace leaves and "
                         f"{len(counts)} counts")
    for path, leaf in traces:
        rest = path[path.index("trace") + 1:]
        out["/".join(("opt/trace",) + rest)] = np.asarray(leaf, np.float32)
    out["opt/count"] = np.asarray(counts[0], np.int32)
    return out


def convert(src: str, dst: str, step: Optional[int] = None) -> int:
    """Convert step `step` (default: the newest intact) of the JAX
    checkpoint directory `src` into the port's directory `dst`; returns
    the step written."""
    import jax

    from distributed_vgg_f_tpu.checkpoint.manager import \
        CheckpointManager as JaxManager
    from distributed_vgg_f_tpu_torch.checkpoint.manager import \
        CheckpointManager
    jmgr = JaxManager(src)
    if step is None:
        step = jmgr.best_step()
        if step is None:
            raise FileNotFoundError(f"no intact checkpoint under {src}")
    meta = jmgr.state_metadata(step)
    template = jax.tree_util.tree_map(
        lambda m: np.zeros(m.shape, m.dtype), meta)
    state, extra = jmgr.restore(template, step)
    jmgr.close()
    arrays = port_arrays(state)
    mgr = CheckpointManager(dst, max_to_keep=None)
    if not mgr.save(arrays, extra=dict(extra), force=True):
        raise FileExistsError(f"step {step} already exists under {dst}")
    mgr.close()
    return int(arrays["step"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="the JAX package's checkpoint directory")
    ap.add_argument("dst", help="the port's checkpoint directory")
    ap.add_argument("--step", type=int, default=None,
                    help="the step to convert (default: newest intact)")
    args = ap.parse_args(argv)
    step = convert(args.src, args.dst, args.step)
    print(f"converted step {step}: {args.src} -> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
