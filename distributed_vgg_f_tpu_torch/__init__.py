"""PyTorch/CUDA port of distributed_vgg_f_tpu for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout module for module, so each
module's counterpart sits at the same relative path. It imports torch and
numpy only: nothing of JAX, Flax, or the JAX package (tests/
test_torch_isolation.py pins that in a subprocess).

This slice serves VGG-F: u8 payloads over HTTP (serving/server.py) through
the dynamic batcher (serving/batcher.py) into a bucketed engine
(serving/engine.py) that runs the device finish, the model and an fp32
softmax (train/predict.py). Both LRN sites of the model run the
hand-written Hopper kernel (ops/lrn_cuda.py, csrc/lrn_fwd.cu) when the
tensor lies on a CUDA device and the plain PyTorch version when it lies on
the CPU.

Entry points default to ``device="cuda"`` and refuse to run without a CUDA
device; the CPU runs only when a caller passes ``device="cpu"``
(device.py).
"""
