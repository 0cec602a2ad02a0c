#!/usr/bin/env python3
"""Write the JPEG fixture the port's data tests and `chip_smoke.py` phase
`train_feed` decode: 16 textured 500x375 RGB images (near ImageNet's usual
shape), baseline JPEG at quality 90, from a fixed seed.

    python tools/make_jpeg_fixture.py [--out tests/data/jpeg_fixture]

Needs numpy and Pillow. The images are committed (the card's host has no
JPEG encoder), so run this only to regenerate them. Each image mixes a
colour gradient, a few oriented gratings and blob-shaped noise, so the
entropy decode has real work to do while the set stays under 1 MB.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

COUNT = 16
WIDTH, HEIGHT = 500, 375
QUALITY = 90
SEED = 20261017


def image(rng: np.random.Generator) -> np.ndarray:
    """One (HEIGHT, WIDTH, 3) uint8 image."""
    y, x = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float32)
    out = np.zeros((HEIGHT, WIDTH, 3), np.float32)
    base = rng.uniform(40, 200, 3)
    slope = rng.uniform(-0.25, 0.25, (2, 3))
    out += base + x[..., None] * slope[0] + y[..., None] * slope[1]
    for _ in range(4):
        theta = rng.uniform(0, np.pi)
        period = rng.uniform(6, 40)
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(8, 30, 3)
        wave = np.sin((x * np.cos(theta) + y * np.sin(theta))
                      * (2 * np.pi / period) + phase)
        out += wave[..., None] * amp
    # blob-shaped noise: coarse noise upsampled, then a little fine grain
    coarse = rng.normal(0, 18, (HEIGHT // 15 + 1, WIDTH // 15 + 1, 3))
    out += np.kron(coarse, np.ones((15, 15, 1)))[:HEIGHT, :WIDTH]
    out += rng.normal(0, 3, out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def main(argv=None) -> int:
    from PIL import Image
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "data", "jpeg_fixture"))
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(SEED)
    total = 0
    for k in range(COUNT):
        path = os.path.join(args.out, f"img_{k:02d}.jpg")
        Image.fromarray(image(rng)).save(path, "JPEG", quality=QUALITY,
                                         subsampling=2)
        total += os.path.getsize(path)
    print(f"{COUNT} images, {total} bytes, in {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
