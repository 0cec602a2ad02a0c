"""Per-model ingest descriptors: what each model's stem consumes from the
u8 ingest wire (packed or plain layout, stem dtype, normalize constants).

An own copy of the JAX package's table. `reject_raw_uint8` compares
against `torch.uint8`: a torch dtype prints as ``torch.uint8``, so the
JAX package's dtype-name comparison would never fire here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

#: The ImageNet normalize constants every zoo model shares.
IMAGENET_MEAN_RGB: Tuple[float, float, float] = (123.68, 116.78, 103.94)
IMAGENET_STDDEV_RGB: Tuple[float, float, float] = (58.393, 57.12, 57.375)


@dataclasses.dataclass(frozen=True)
class IngestDescriptor:
    """What one model's stem consumes from the ingest wire."""
    model: str
    #: stem consumes the 4x4-packed (S/4, S/4, 48) layout (VGG-F only)
    space_to_depth: bool = False
    #: compute dtype the stem casts pixels into (the model default)
    stem_dtype: str = "bfloat16"
    #: per-model normalize constants the device finish applies
    mean_rgb: Tuple[float, float, float] = IMAGENET_MEAN_RGB
    stddev_rgb: Tuple[float, float, float] = IMAGENET_STDDEV_RGB
    #: the ingest wire the model's preset ships (u8 for the whole zoo)
    wire: str = "u8"
    #: raw wire pixels may reach the stem directly (never, for the zoo)
    accepts_uint8: bool = False
    #: the model exists for serving only (the distilled student)
    serving_only: bool = False

    def describe(self) -> dict:
        """JSON-ready receipt for routing-table rows."""
        return {"model": self.model, "wire": self.wire,
                "space_to_depth": self.space_to_depth,
                "stem_dtype": self.stem_dtype}


#: The zoo contract table — one row per registered model.
INGEST_DESCRIPTORS: Dict[str, IngestDescriptor] = {
    "vggf": IngestDescriptor("vggf", space_to_depth=True),
    "vgg16": IngestDescriptor("vgg16"),
    "resnet50": IngestDescriptor("resnet50"),
    "vit_s16": IngestDescriptor("vit_s16"),
    "vggf_student": IngestDescriptor("vggf_student", space_to_depth=True,
                                     serving_only=True),
}


def reject_raw_uint8(x: torch.Tensor, model_name: str) -> None:
    """Raw wire pixels must be finished (data/device_ingest.py) before any
    stem: casting 0..255 integers to the compute dtype would feed the model
    an input ~50x off the normalized one, with no error."""
    if x.dtype == torch.uint8:
        raise TypeError(
            f"{model_name} received a raw uint8 batch — apply the "
            "device-finish prologue (data/device_ingest.py "
            "make_device_finish) before the model; the predict forward "
            "installs it automatically")


def ingest_descriptor(model_name: str) -> IngestDescriptor:
    """The model's ingest contract; unknown models get the conservative
    unpacked default."""
    desc = INGEST_DESCRIPTORS.get(model_name)
    if desc is None:
        return IngestDescriptor(model_name)
    return desc
