"""Data plane of the port: the train stream's sources (`build_dataset`:
seeded u8 batches, data/synthetic.py, or ImageNet TFRecords through the
native decoder, data/imagenet.py), the cursor-counting ingest
(data/iterator_state.py), the host and device read-ahead stages
(data/prefetch.py) and the ingest autotuner that steers them
(data/autotune.py), the device finish of the u8 wire
(data/device_ingest.py), the train step's on-device augmentation
(data/augment.py) and the procedural teacher task (data/teacher.py) the
distillation tool trains on."""


def build_dataset(data_cfg, split: str = "train", *, seed: int = 0,
                  num_shards: int = 1, shard_index: int = 0,
                  num_classes: int | None = None):
    """This process's iterator of host batches for `split` — the
    counterpart of the JAX package's ``data/__init__.py build_dataset``
    (:11). Each of `num_shards` processes gets `global_batch_size /
    num_shards` rows a batch. `num_classes` is the model head's width,
    the label space of synthetic batches."""
    if data_cfg.global_batch_size % num_shards != 0:
        raise ValueError(
            f"global batch {data_cfg.global_batch_size} not divisible by "
            f"{num_shards} host shards")
    local_batch = data_cfg.global_batch_size // num_shards
    if data_cfg.name == "synthetic":
        from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
        return SyntheticU8(local_batch, data_cfg.image_size,
                           num_classes or 1000, seed=seed + shard_index)
    if data_cfg.name == "imagenet":
        from distributed_vgg_f_tpu_torch.data.imagenet import build_imagenet
        return build_imagenet(data_cfg, split, local_batch, seed=seed,
                              num_shards=num_shards, shard_index=shard_index)
    raise KeyError(f"unknown dataset {data_cfg.name!r}: the port has "
                   "'synthetic' and 'imagenet'")
