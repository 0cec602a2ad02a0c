"""PyTorch/CUDA port of distributed_vgg_f_tpu for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout module for module, so each
module's counterpart sits at the same relative path. It imports torch and
numpy only: nothing of JAX, Flax, or the JAX package (tests/
test_torch_isolation.py pins that in a subprocess).

It serves VGG-F: u8 payloads over HTTP (serving/server.py) through the
dynamic batcher (serving/batcher.py), its window steered by the
admission controller (serving/controller.py), into a bucketed engine
(serving/engine.py) that runs the device finish, the model and an fp32
softmax (train/predict.py), one engine a tier of the ladder
(serving/tiers.py: bf16, int8 heads, the student that train/distill.py
distils on the teacher task, data/teacher.py). It trains VGG-F: the core loop
(train/trainer.py) feeds the train step (train/step.py) from the
flagship's ImageNet TFRecords through the native decoder (data/
native_tfrecord.py, data/native_jpeg.py, built by data/native_build.py)
into pinned host buffers, copied to the card on a side stream
(data/prefetch.py), or from seeded u8 batches (data/synthetic.py); the
step runs finish, flip and mixup (data/augment.py), the
forward with dropout, CE plus coupled L2 (ops/losses.py), the backward,
clipping, SGD with momentum on the schedule (train/schedule.py), the EMA
and the non-finite skip (resilience/guard.py). Both LRN sites of the
model, each with the ReLU before it fused in, go through an autograd
Function (ops/lrn.py relu_lrn) whose forward and backward run the
hand-written Hopper kernels (ops/lrn_cuda.py, csrc/lrn_fwd.cu,
csrc/lrn_bwd.cu) when the tensor lies on a CUDA device and the plain
PyTorch versions when it lies on the CPU.

Entry points (`build_engine`, `serve_from_params`, `Trainer`,
`build_train_step`, `train_distilled`, ...) default to ``device="cuda"`` and refuse to run
without a CUDA device; the CPU runs only when a caller passes
``device="cpu"`` (device.py).
"""
