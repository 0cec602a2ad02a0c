"""The native decoder's tuning surface in the port
(distributed_vgg_f_tpu_torch/data/native_jpeg.py) against the JAX
package's (data/native_jpeg.py:229–676), on the committed JPEG fixture
(tests/data/jpeg_fixture, 500x375) and on its restart-marker re-encodes:

- each getter returns what JAX's returns on this host, and each switch
  (SIMD, scaled decode, restart, fan-out) round-trips as JAX's does; the
  two packages load their own builds of the one C source, so each switch
  is set on both;
- the native scale chooser of the port's build equals
  `expected_scale_denom` (and JAX's chooser) over a grid;
- `decode_single_image` is byte-equal to JAX's over the dtypes, crop
  modes, flip ownership and seeds, into `out=` too, and None on a corrupt
  JPEG;
- `reencode_restart` gives JAX's bytes; restart on and off, and fan-out 1
  and 4, decode the re-encoded fixture to the same pixels (batch loader
  and single image), and the restart path is receipted in
  `restart_stats`;
- `decode_stats` and `decode_profile` carry JAX's keys and count a pass."""

import os

import numpy as np
import pytest

from distributed_vgg_f_tpu.data import native_jpeg as jjpeg
from distributed_vgg_f_tpu_torch.data import native_jpeg as pjpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "jpeg_fixture")
MEAN = np.array([123.68, 116.78, 103.94], np.float32)
STD = np.array([58.393, 57.12, 57.375], np.float32)

SWITCHES = (("set_simd", "simd_kind", lambda k: k != "scalar"),
            ("set_scaled", "scaled_kind", lambda k: k == "scaled"),
            ("set_restart", "restart_kind", lambda k: k == "restart"))


@pytest.fixture(autouse=True)
def _restore_dispatch():
    """Every test leaves both libraries' switches as it found them."""
    before = [(mod, setter, is_on(getattr(mod, getter)()))
              for mod in (pjpeg, jjpeg) for setter, getter, is_on in SWITCHES]
    yield
    for mod, setter, on in before:
        getattr(mod, setter)(on)
    for mod in (pjpeg, jjpeg):
        mod.set_restart_fanout(1)


@pytest.fixture(scope="module")
def fixture_jpegs():
    out = []
    for f in sorted(os.listdir(FIXTURE)):
        with open(os.path.join(FIXTURE, f), "rb") as fh:
            out.append(fh.read())
    return out


@pytest.fixture(scope="module")
def marked(fixture_jpegs):
    """Restart-marker re-encodes of four fixture JPEGs: a marker every MCU
    row (interval 0) and every 7 MCUs."""
    return [pjpeg.reencode_restart(d, interval)
            for d in fixture_jpegs[:4] for interval in (0, 7)]


# ------------------------------------------------------------- the getters
@pytest.mark.parametrize("name", [
    "simd_kind", "scaled_kind", "partial_supported", "restart_kind",
    "restart_fanout", "wire_u8_enabled"])
def test_each_getter_returns_what_jax_returns(name):
    assert getattr(pjpeg, name)() == getattr(jjpeg, name)()


@pytest.mark.parametrize("setter,getter,is_on", SWITCHES)
def test_each_switch_round_trips_as_jax(setter, getter, is_on):
    for on in (False, True, False, True):
        got = getattr(pjpeg, setter)(on)
        assert got == getattr(jjpeg, setter)(on)
        assert getattr(pjpeg, getter)() == got == getattr(jjpeg, getter)()
        assert on or not is_on(got)


def test_the_fanout_switch_round_trips_as_jax():
    for width in (4, 0, 65, 1):
        assert pjpeg.set_restart_fanout(width) == \
            jjpeg.set_restart_fanout(width)
        assert pjpeg.restart_fanout() == jjpeg.restart_fanout()
    assert pjpeg.set_restart_fanout(0) == 1          # clamped, as JAX


# ---------------------------------------------------------- scale chooser
def test_choose_scale_equals_its_mirror_over_a_grid():
    choose_scale = pjpeg.load_native_jpeg().dvgg_jpeg_choose_scale
    for crop_w in (7, 28, 56, 111, 112, 113, 224, 225, 447, 448, 500, 896,
                   1793):
        for crop_h in (28, 112, 224, 375, 448, 1800):
            for out in (1, 32, 56, 112, 224):
                want = pjpeg.expected_scale_denom(crop_w, crop_h, out)
                assert choose_scale(crop_w, crop_h, out) == want
                assert jjpeg.choose_scale(crop_w, crop_h, out) == want
                assert jjpeg.expected_scale_denom(crop_w, crop_h, out) == \
                    want
    assert pjpeg.SCALE_CANDIDATES == jjpeg.SCALE_CANDIDATES


# ------------------------------------------------------ one-image decode
@pytest.mark.parametrize("image_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("eval_mode", [False, True])
@pytest.mark.parametrize("hflip", [True, False])
def test_decode_single_image_is_byte_equal_to_jax(fixture_jpegs, image_dtype,
                                                  eval_mode, hflip):
    for k, data in enumerate(fixture_jpegs[::3]):
        for out_size in (32, 224):
            kw = dict(image_dtype=image_dtype, eval_mode=eval_mode,
                      rng_seed=(k * 7919 + out_size) % 1000, hflip=hflip)
            got = pjpeg.decode_single_image(data, out_size, MEAN, STD, **kw)
            want = jjpeg.decode_single_image(data, out_size, MEAN, STD,
                                             **kw)
            assert got.dtype == np.dtype(image_dtype)
            assert got.shape == (out_size, out_size, 3)
            np.testing.assert_array_equal(got, want)
            into = np.full((out_size, out_size, 3), 7, image_dtype)
            assert pjpeg.decode_single_image(data, out_size, MEAN, STD,
                                             out=into, **kw) is into
            np.testing.assert_array_equal(into, want)


def test_hflip_false_is_the_same_crop_unflipped(fixture_jpegs):
    """The flip bit is drawn either way: a flips-on decode is the
    flips-off crop, flipped or not."""
    data = fixture_jpegs[5]
    for seed in range(8):
        on = pjpeg.decode_single_image(data, 64, MEAN, STD,
                                       image_dtype="uint8", rng_seed=seed)
        off = pjpeg.decode_single_image(data, 64, MEAN, STD,
                                        image_dtype="uint8", rng_seed=seed,
                                        hflip=False)
        assert (np.array_equal(on, off)
                or np.array_equal(on, off[:, ::-1, :]))


def test_decode_single_image_refuses_a_wrong_out_and_fails_a_corrupt_jpeg(
        fixture_jpegs):
    data = fixture_jpegs[0]
    for out, match in ((np.empty((32, 32, 3), np.float32), "dtype"),
                       (np.empty((32, 31, 3), np.uint8), "shape"),
                       (np.empty((32, 64, 3), np.uint8)[:, ::2], "contig")):
        with pytest.raises(ValueError, match=match):
            pjpeg.decode_single_image(data, 32, MEAN, STD,
                                      image_dtype="uint8", out=out)
    with pytest.raises(ValueError, match="image_dtype"):
        pjpeg.decode_single_image(data, 32, MEAN, STD, image_dtype="bf16")
    bad = b"\xff\xd8\xffnot a real jpeg at all"
    assert pjpeg.decode_single_image(bad, 32, MEAN, STD) is None
    assert jjpeg.decode_single_image(bad, 32, MEAN, STD) is None


# ---------------------------------------------------- restart and fan-out
@pytest.mark.parametrize("interval", [0, 7])
def test_reencode_restart_gives_jax_bytes(fixture_jpegs, interval):
    for data in fixture_jpegs[::2]:
        got = pjpeg.reencode_restart(data, interval)
        assert got and got == jjpeg.reencode_restart(data, interval)
    assert pjpeg.reencode_restart(b"\xff\xd8\xffjunk", 0) is None
    with pytest.raises(ValueError):
        pjpeg.reencode_restart(fixture_jpegs[0], -3)


def test_reencoded_pixels_are_the_sources(fixture_jpegs):
    """A coefficient-domain copy: the same pixels as the source."""
    assert pjpeg.set_restart(False) == "sequential"
    for data in fixture_jpegs[:4]:
        marked = pjpeg.reencode_restart(data, 0)
        for seed in (0, 3):
            np.testing.assert_array_equal(
                pjpeg.decode_single_image(marked, 224, MEAN, STD,
                                          image_dtype="uint8",
                                          rng_seed=seed),
                pjpeg.decode_single_image(data, 224, MEAN, STD,
                                          image_dtype="uint8",
                                          rng_seed=seed))


@pytest.mark.parametrize("fanout", [1, 4])
@pytest.mark.parametrize("image_dtype", ["uint8", "float32"])
def test_restart_and_sequential_decode_the_same(marked, fanout,
                                                image_dtype):
    pjpeg.set_restart_fanout(fanout)
    before = pjpeg.restart_stats()
    for data in marked:
        for seed in (0, 1, 2):
            assert pjpeg.set_restart(False) == "sequential"
            ref = pjpeg.decode_single_image(data, 224, MEAN, STD,
                                            image_dtype=image_dtype,
                                            rng_seed=seed)
            assert pjpeg.set_restart(True) == "restart"
            out = pjpeg.decode_single_image(data, 224, MEAN, STD,
                                            image_dtype=image_dtype,
                                            rng_seed=seed)
            np.testing.assert_array_equal(ref, out)
    after = pjpeg.restart_stats()
    assert list(after) == list(jjpeg.restart_stats())
    assert after["images"] > before["images"]
    assert after["segments_skipped"] > before["segments_skipped"]
    if fanout > 1:
        assert after["fanout_images"] > before["fanout_images"]
        assert after["fanout_width_max"] >= fanout


def test_restart_batch_loader_decodes_the_same(marked, tmp_path):
    files = []
    for k, data in enumerate(marked):
        files.append(str(tmp_path / f"m{k}.jpg"))
        with open(files[-1], "wb") as f:
            f.write(data)
    labels = list(range(len(files)))
    batches = {}
    for kind, on, fanout in (("sequential", False, 1), ("restart", True, 1),
                             ("restart", True, 4)):
        assert pjpeg.set_restart(on) == kind
        pjpeg.set_restart_fanout(fanout)
        it = pjpeg.NativeJpegTrainIterator(files, labels, 4, 64, seed=9,
                                           mean=MEAN, std=STD,
                                           image_dtype="uint8",
                                           num_threads=2)
        batches[(kind, fanout)] = [next(it) for _ in range(4)]
        it.close()
    ref = batches[("sequential", 1)]
    for key in (("restart", 1), ("restart", 4)):
        for a, b in zip(ref, batches[key]):
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])


def test_markerless_fixture_rides_the_sequential_path(fixture_jpegs):
    assert pjpeg.set_restart(True) == "restart"
    before = pjpeg.restart_stats()
    pjpeg.decode_single_image(fixture_jpegs[0], 64, MEAN, STD, rng_seed=1)
    after = pjpeg.restart_stats()
    assert after["marker_absent"] == before["marker_absent"] + 1
    assert after["images"] == before["images"]


# --------------------------------------------------------------- receipts
def test_decode_stats_and_profile_count_a_pass(fixture_jpegs):
    pjpeg.decode_stats(reset=True)
    pjpeg.decode_profile(reset=True)
    assert pjpeg.decode_stats()["images"] == 0
    for seed in range(5):
        pjpeg.decode_single_image(fixture_jpegs[seed], 64, MEAN, STD,
                                  image_dtype="uint8", rng_seed=seed)
    st, prof = pjpeg.decode_stats(), pjpeg.decode_profile()
    assert set(st) == set(jjpeg.decode_stats())
    assert set(prof) == set(jjpeg.decode_profile())
    assert st["images"] == 5 and sum(st["scale_histogram"].values()) == 5
    assert prof["images"] == 5 and prof["jpeg_s"] > 0
    assert pjpeg.decode_stats(reset=True)["images"] == 5
    assert pjpeg.decode_stats()["images"] == 0


def test_scaled_and_full_and_simd_and_scalar_decode_the_same(
        fixture_jpegs):
    """The 375 px center crop resized to 224 keeps scale 8/8, where the
    partial decode is the full decode byte for byte (JAX
    `test_scale8_partial_vs_full_byte_identical`), and the SIMD resample
    is the scalar one byte for byte (JAX `test_single_image_parity`); each
    equal to JAX's decode under the same switches."""
    assert pjpeg.expected_scale_denom(375, 375, 224) == 8
    data = fixture_jpegs[2]
    outs = []
    for simd in (False, True):
        for scaled in (False, True):
            for mod in (pjpeg, jjpeg):
                mod.set_simd(simd)
                mod.set_scaled(scaled)
            got = pjpeg.decode_single_image(data, 224, MEAN, STD,
                                            image_dtype="uint8",
                                            eval_mode=True)
            np.testing.assert_array_equal(got, jjpeg.decode_single_image(
                data, 224, MEAN, STD, image_dtype="uint8", eval_mode=True))
            outs.append(got)
    for got in outs[1:]:
        np.testing.assert_array_equal(got, outs[0])
