"""The flagship's VGG-F at full width through both trainers: the port's
`Trainer.fit` against the JAX package's `Trainer.fit`, on the CPU.

`vggf_imagenet_dp` as it is — 224 px, 1000 classes, the packed stem
(4x4 space-to-depth), LRN after conv1 and conv2, fc6/fc7 at 4096, CE with
the coupled L2 (5e-4), SGD with momentum 0.9 at the preset's LR scaled to
the batch — in fp32, with dropout, flip and mixup off (torch cannot
reproduce JAX's threefry draws). Global batch 4 on one process and on a
one-device mesh (the preset's ZeRO-2 downgrades to replicated SGD on one
shard in both), 3 steps from the same weights (weights.init_params gives
the Flax tree both start from), fed the same seeded u8 batches.

Tolerance: losses within rtol 1e-5. The first loss is one forward:
fp32 convolutions summed in different orders by two libraries (oneDNN
through torch, XLA's Eigen) differ by ~1e-7 relative at each layer; the
softmax over 1000 classes of near-uniform logits keeps the loss near
ln 1000 = 6.91, so the difference stays at a few ulps of the loss.
The next two losses add the updates' differences: gradients that differ
by ~1e-6 relative times the step's LR (0.01 x 4 / 256 = 1.6e-4) move
the weights by far less than they already differ, so the bound of the
narrowed 10-step test (tests/test_torch_trainer_jax.py, rtol 1e-5) holds
at full width with room to spare: on the CPU host this was written on,
the three float32 losses came out equal (6.8139, 6.8194, 6.8388 in both),
and the gap is printed on failure."""

import io
import json

import jax
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu.parallel.mesh import MeshSpec, build_mesh
from distributed_vgg_f_tpu.train.trainer import Trainer as JaxTrainer
from distributed_vgg_f_tpu.utils.logging import MetricLogger as JaxLogger
from distributed_vgg_f_tpu_torch import config as tcfg
from distributed_vgg_f_tpu_torch.train.trainer import Trainer
from distributed_vgg_f_tpu_torch.weights import init_params

BATCH, STEPS = 4, 3

#: The cuts both packages take: fp32, no dropout, no flip or mixup, the
#: global batch; everything else is the preset's
CUTS = {"model.compute_dtype": "float32", "model.dropout_rate": "0.0",
        "data.augment.enabled": "false",
        "data.global_batch_size": str(BATCH), "train.seed": "0",
        "train.log_every": "1"}


def _batches():
    rng = np.random.default_rng(7)
    return [{"image": rng.integers(0, 256, (BATCH, 224, 224, 3),
                                   dtype=np.uint8),
             "label": rng.integers(0, 1000, (BATCH,), dtype=np.int32)}
            for _ in range(STEPS)]


def test_full_width_flagship_losses_match_the_jax_trainer(tmp_path):
    batches = _batches()
    cfg = tcfg.apply_overrides(tcfg.get_config("vggf_imagenet_dp"), CUTS)
    assert (cfg.data.image_size, cfg.model.num_classes,
            cfg.data.space_to_depth) == (224, 1000, True)
    port = Trainer(cfg, device="cpu")
    port.fit(port.init_state(),
             [{k: torch.from_numpy(v) for k, v in b.items()}
              for b in batches], num_steps=STEPS)
    got = np.array([r["loss"] for r in port.records
                    if r["event"] == "train"])

    jsonl = str(tmp_path / "jax.jsonl")
    jax_cfg = jcfg.apply_overrides(jcfg.get_config("vggf_imagenet_dp"), {
        **CUTS, "data.name": "synthetic", "train.steps": str(STEPS),
        "telemetry.enabled": "false", "data.autotune.enabled": "false",
        "mesh.num_data": "0"})
    mesh = build_mesh(MeshSpec(("data",), (1,)), devices=jax.devices()[:1])
    ref = JaxTrainer(jax_cfg, mesh=mesh,
                     logger=JaxLogger(jsonl_path=jsonl, stream=io.StringIO()))
    state = ref.init_state()
    tree = init_params(cfg.model, cfg.train.seed, image_size=224)
    state = state.replace(params=jax.device_put(tree,
                                                NamedSharding(mesh, P())))
    ref.fit(state, dataset=iter(batches), num_steps=STEPS)
    with open(jsonl) as f:
        want = np.array([r["loss"] for r in map(json.loads, f)
                         if r["event"] == "train"])
    assert len(got) == len(want) == STEPS
    assert np.all(np.abs(got - np.log(1000.0)) < 1.0), got
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               err_msg=f"gap {np.abs(got / want - 1)}")
