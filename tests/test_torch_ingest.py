"""The port's device finish (distributed_vgg_f_tpu_torch/data/
device_ingest.py) against the JAX package's: bitwise in fp32 and bf16 on
every u8 value in every channel, with the same space-to-depth channel
order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu.data.device_ingest import \
    make_device_finish as jax_finish
from distributed_vgg_f_tpu.data.device_ingest import \
    space_to_depth_batch as jax_space_to_depth
from distributed_vgg_f_tpu_torch.data.device_ingest import (
    make_device_finish,
    space_to_depth_batch,
)
from distributed_vgg_f_tpu_torch.models.ingest import (IMAGENET_MEAN_RGB,
                                                       IMAGENET_STDDEV_RGB,
                                                       ingest_descriptor)


def _all_u8_values():
    """(1, 16, 16, 3): every value 0..255 in each of the three channels."""
    plane = np.arange(256, dtype=np.uint8).reshape(16, 16)
    return np.stack([plane, plane[::-1], plane.T], axis=-1)[None]


@pytest.mark.parametrize("image_dtype", ["float32", "bfloat16"])
def test_finish_bitwise_equals_jax_on_every_u8_value(image_dtype):
    u8 = _all_u8_values()
    want = np.asarray(jax_finish(IMAGENET_MEAN_RGB, IMAGENET_STDDEV_RGB,
                                 image_dtype=image_dtype)(jnp.asarray(u8))
                      .astype(jnp.float32))
    got = make_device_finish(IMAGENET_MEAN_RGB, IMAGENET_STDDEV_RGB,
                             image_dtype=image_dtype)(torch.from_numpy(u8))
    assert got.dtype == getattr(torch, image_dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_finish_passes_float_batches_untouched():
    finish = make_device_finish(IMAGENET_MEAN_RGB, IMAGENET_STDDEV_RGB)
    x = torch.randn(2, 4, 4, 3)
    assert finish(x) is x
    once = finish(torch.from_numpy(_all_u8_values()))
    assert finish(once) is once


def test_space_to_depth_keeps_jax_channel_order():
    x = np.random.default_rng(0).standard_normal(
        (2, 8, 12, 3)).astype(np.float32)
    want = np.asarray(jax_space_to_depth(jnp.asarray(x)))
    got = space_to_depth_batch(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_finish_rejects_unknown_image_dtype():
    with pytest.raises(ValueError, match="image_dtype"):
        make_device_finish(IMAGENET_MEAN_RGB, IMAGENET_STDDEV_RGB,
                           image_dtype="float16")


def test_descriptor_table_matches_jax():
    from distributed_vgg_f_tpu.models import ingest as jax_ingest
    for name, desc in jax_ingest.INGEST_DESCRIPTORS.items():
        assert ingest_descriptor(name).describe() == desc.describe()
        assert ingest_descriptor(name).mean_rgb == desc.mean_rgb
        assert ingest_descriptor(name).stddev_rgb == desc.stddev_rgb
    assert ingest_descriptor("unknown").space_to_depth is False
