"""The port's ingest autotuner (distributed_vgg_f_tpu_torch/data/
autotune.py) against the JAX package's data/autotune.py: the same fake
knobs on both sides, driven by the scripted verdict sequences of JAX's
tests/test_autotune.py (hysteresis, streak reset, cooldown, rails,
compute-bound quiet, alternation, the oscillation freeze, relax to the
baseline, the refused knob, settled) and by 200 seeded random verdict
streams over random configs and knob sets. After every window the two
`observe` records are equal, and at the end `describe()`, the knob values
and the `autotune/*` counters and gauges are equal; the actuations'
`ts_unix` (wall-clock stamps) are left out. Every record validates under
the port's schema and JAX's `validate_autotune_block` /
`validate_autotune_receipt`. The port's settings are module constants
(data/autotune.py), set per case here to the config JAX's controller is
given. Then the port-only surfaces: the kill switch, the constants
against JAX's config defaults, and the knob factories."""

from dataclasses import fields as dataclasses_fields

import numpy as np
import pytest

from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu import telemetry as jtele
from distributed_vgg_f_tpu.data import autotune as jat
from distributed_vgg_f_tpu.telemetry import schema as jschema
from distributed_vgg_f_tpu_torch import config as tcfg
from distributed_vgg_f_tpu_torch import telemetry as ptele
from distributed_vgg_f_tpu_torch.data import autotune as pat
from distributed_vgg_f_tpu_torch.telemetry import schema as pschema

INFEED = {"verdict": "infeed_bound"}
COMPUTE = {"verdict": "compute_bound"}
CKPT = {"verdict": "checkpoint_bound"}
GUARD = {"verdict": "guard_stalled"}
VERDICT_POOL = [INFEED, COMPUTE, CKPT, GUARD, None, {}]

COUNTERS = ("autotune/windows", "autotune/actuations",
            "autotune/blocked_hysteresis", "autotune/blocked_cooldown",
            "autotune/blocked_rail", "autotune/oscillation_freezes")
GAUGES = ("autotune/native_threads", "autotune/host_prefetch",
          "autotune/prefetch_to_device", "autotune/restart_fanout",
          "autotune/wire_u8", "autotune/settled")


#: JAX's AutotuneConfig fields the port keeps as data/autotune.py constants
SETTINGS = ("k_windows", "cooldown_windows", "settled_after_windows",
            "relax_after_windows", "freeze_after_flips", "history")
RAILS = ("min_threads", "max_threads", "min_prefetch", "max_prefetch",
         "min_prefetch_to_device", "max_prefetch_to_device")


class FakeTarget:
    """A settable integer: refuses every apply (`refuse`), or clamps it
    to `clamp` (a subsystem's own ceiling)."""

    def __init__(self, value, refuse=False, clamp=None):
        self.value, self.refuse, self.clamp = value, refuse, clamp

    def get(self):
        return self.value

    def apply(self, n):
        if self.refuse:
            return None
        self.value = n if self.clamp is None else min(n, self.clamp)
        return self.value


class NullFlight:
    def record_actuation(self, act):
        pass


def _pair(monkeypatch, cfg_kw, knobs):
    """(port tuner, port registry, port targets), the same for JAX: JAX's
    controller given `cfg_kw` as its config, the port's constants set to
    the same. `knobs`: (name, start, lo, hi, geometric, refuse, clamp)
    rows."""
    jax_cfg = jcfg.AutotuneConfig(enabled=True, **cfg_kw)
    for name in SETTINGS:
        monkeypatch.setattr(pat, name.upper(), getattr(jax_cfg, name))
    out = []
    for at, tele, flight in ((pat, ptele, None), (jat, jtele, NullFlight())):
        targets = [FakeTarget(start, refuse, clamp)
                   for _, start, _, _, _, refuse, clamp in knobs]
        made = [at.Knob(name, t.get, t.apply, lo, hi, geometric=geo)
                for (name, _, lo, hi, geo, _, _), t in zip(knobs, targets)]
        ticks = iter(float(i) for i in range(1, 10 ** 6))
        reg = tele.TelemetryRegistry()
        args = (made,) if at is pat else (jax_cfg, made)
        out.append((at.IngestAutotuner(*args, registry=reg, flight=flight,
                                       clock=lambda t=ticks: next(t)),
                    reg, targets))
    return out


def _untimed(record):
    record = dict(record)
    for key in ("actuations", "history"):
        if key in record:
            record[key] = [{k: v for k, v in a.items() if k != "ts_unix"}
                           for a in record[key]]
    return record


def _drive(monkeypatch, cfg_kw, knobs, verdicts):
    """Both controllers over `verdicts`; asserts each window's records
    equal and valid, then the end state. Returns the port's records."""
    (pt, preg, ptargets), (jt, jreg, jtargets) = _pair(monkeypatch, cfg_kw,
                                                       knobs)
    records = []
    for stall in verdicts:
        got, want = pt.observe(stall), jt.observe(stall)
        assert _untimed(got) == _untimed(want), (len(records), stall)
        for validate in (pschema.validate_autotune_block,
                         jschema.validate_autotune_block):
            errors = []
            validate(got, "autotune", errors)
            assert errors == []
        records.append(got)
    desc = pt.describe()
    assert _untimed(desc) == _untimed(jt.describe())
    for validate in (pschema.validate_autotune_receipt,
                     jschema.validate_autotune_receipt):
        errors = []
        validate(desc, "autotune", errors)
        assert errors == []
    assert [t.value for t in ptargets] == [t.value for t in jtargets]
    assert pt.settled == jt.settled
    assert pt.actuations_total == jt.actuations_total
    assert _untimed({"history": pt.history()}) == \
        _untimed({"history": jt.history()})
    for name in COUNTERS:
        assert preg.counter_value(name) == jreg.counter_value(name), name
    for name in GAUGES:
        assert preg.gauge(name) == jreg.gauge(name), name
    return records, pt, ptargets


def _knob(name="host_prefetch", start=1, lo=1, hi=8, geo=False,
          refuse=False, clamp=None):
    return (name, start, lo, hi, geo, refuse, clamp)


#: JAX tests/test_autotune.py:79–246, as (config, knobs, verdicts).
SCRIPTED = {
    "no_actuation_below_k": (
        dict(k_windows=3, cooldown_windows=1, settled_after_windows=3),
        [_knob()], [INFEED] * 3),
    "streak_resets_on_verdict_change": (
        dict(k_windows=2, cooldown_windows=1, settled_after_windows=3),
        [_knob()], [INFEED, COMPUTE, INFEED]),
    "cooldown_blocks_after_actuation": (
        dict(k_windows=1, cooldown_windows=3, settled_after_windows=3),
        [_knob()], [INFEED] * 5),
    "rail_clamping_and_bounded_actuation_count": (
        dict(k_windows=1, cooldown_windows=0, settled_after_windows=3),
        [_knob("native_threads", geo=True)], [INFEED] * 20),
    "compute_bound_produces_zero_actuations": (
        dict(k_windows=1, cooldown_windows=0, settled_after_windows=3),
        [_knob(start=2)], [COMPUTE, COMPUTE, CKPT, GUARD, COMPUTE, None]),
    "alternating_verdicts_converge_to_noop": (
        dict(k_windows=2, cooldown_windows=0, settled_after_windows=3,
             relax_after_windows=2),
        [_knob()], [INFEED, COMPUTE] * 15),
    "oscillation_guard_freezes_flipping_knob": (
        dict(k_windows=1, cooldown_windows=0, settled_after_windows=3,
             relax_after_windows=1, freeze_after_flips=2),
        [_knob(start=2)], [INFEED, COMPUTE] * 20 + [INFEED] * 6),
    "relax_steps_back_down_to_baseline_only": (
        dict(k_windows=1, cooldown_windows=0, settled_after_windows=3,
             relax_after_windows=2, freeze_after_flips=99),
        [_knob(start=2)], [INFEED] * 2 + [COMPUTE] * 30),
    "relax_geometric_never_overshoots_baseline": (
        dict(k_windows=1, cooldown_windows=0, settled_after_windows=3,
             relax_after_windows=1, freeze_after_flips=99),
        [_knob("native_threads", start=5, geo=True)],
        [INFEED] + [COMPUTE] * 6),
    "escalation_order_and_refused_knob_skipped": (
        dict(k_windows=1, cooldown_windows=0, settled_after_windows=3),
        [_knob("native_threads", refuse=True), _knob()], [INFEED]),
    "settled_flag_timing": (
        dict(k_windows=1, cooldown_windows=0, settled_after_windows=3),
        [_knob(hi=2)], [INFEED, COMPUTE, COMPUTE, COMPUTE]),
    "clamped_by_the_subsystem": (
        dict(k_windows=1, cooldown_windows=0, settled_after_windows=2),
        [_knob("native_threads", start=2, geo=True, clamp=4),
         _knob("prefetch_to_device", start=2, hi=4)], [INFEED] * 8),
}


@pytest.mark.parametrize("name", sorted(SCRIPTED))
def test_scripted_sequences_equal_jax(name, monkeypatch):
    cfg_kw, knobs, verdicts = SCRIPTED[name]
    records, tuner, targets = _drive(monkeypatch, cfg_kw, knobs, verdicts)
    # a few of JAX's own expectations, held on the port's side
    if name == "no_actuation_below_k":
        assert [r.get("blocked") for r in records[:2]] == ["hysteresis"] * 2
        assert records[2]["actuations"][0]["to"] == 2
    if name == "rail_clamping_and_bounded_actuation_count":
        assert targets[0].value == 8 and tuner.actuations_total == 3
        assert records[-1]["blocked"] == "rail"
    if name == "oscillation_guard_freezes_flipping_knob":
        assert tuner.knobs[0].frozen
    if name == "relax_steps_back_down_to_baseline_only":
        assert targets[0].value == 2
    if name == "escalation_order_and_refused_knob_skipped":
        assert records[0]["actuations"][0]["knob"] == "host_prefetch"
        assert not tuner.knobs[0].available


KNOB_NAMES = ("native_threads", "host_prefetch", "prefetch_to_device",
              "restart_fanout")   # the last JAX's only: a name to the rules


def _random_case(rng):
    cfg_kw = dict(
        k_windows=int(rng.integers(1, 5)),
        cooldown_windows=int(rng.integers(0, 4)),
        settled_after_windows=int(rng.integers(1, 8)),
        relax_after_windows=int(rng.choice([0, 0, 1, 2, 4])),
        freeze_after_flips=int(rng.integers(1, 5)),
        history=int(rng.choice([2, 8, 64])))
    knobs = []
    for name in rng.permutation(KNOB_NAMES)[:int(rng.integers(1, 5))]:
        lo = int(rng.integers(1, 3))
        hi = lo + int(rng.integers(0, 8))
        start = int(rng.integers(lo, hi + 1))
        knobs.append(_knob(str(name), start, lo, hi,
                           geo=bool(rng.integers(0, 2)),
                           refuse=bool(rng.random() < 0.1),
                           clamp=(int(rng.integers(lo, hi + 1))
                                  if rng.random() < 0.2 else None)))
    # streams with runs, so hysteresis passes as well as blocks
    verdicts = []
    while len(verdicts) < int(rng.integers(5, 80)):
        verdicts += [VERDICT_POOL[int(rng.integers(0, len(VERDICT_POOL)))]
                     ] * int(rng.integers(1, 7))
    return cfg_kw, knobs, verdicts


@pytest.mark.parametrize("chunk", range(8))
def test_random_verdict_streams_equal_jax(chunk, monkeypatch):
    """200 seeded streams in all, 25 a case."""
    for seed in range(chunk * 25, chunk * 25 + 25):
        _drive(monkeypatch, *_random_case(np.random.default_rng(seed)))


# ------------------------------------------------------------ port-only
def test_kill_switch_and_activation(monkeypatch):
    on = tcfg.AutotuneConfig(enabled=True)
    monkeypatch.delenv(pat.ENV_KILL, raising=False)
    assert pat.ENV_KILL == jat.ENV_KILL == "DVGGF_AUTOTUNE"
    assert pat.autotune_active(on) and not pat.autotune_killed()
    assert not pat.autotune_active(tcfg.AutotuneConfig())
    monkeypatch.setenv(pat.ENV_KILL, "0")
    assert pat.autotune_killed() and not pat.autotune_active(on)
    monkeypatch.setenv(pat.ENV_KILL, "1")
    assert pat.autotune_active(on)


def test_config_defaults_and_checks_equal_jax():
    """The port's settings and rails are JAX's config defaults, kept as
    constants; its config has the switch alone, and a `--set` of another
    JAX key raises naming its ROADMAP item where JAX takes it."""
    ref = jcfg.AutotuneConfig()
    for name in SETTINGS + RAILS:
        assert getattr(pat, name.upper()) == getattr(ref, name), name
    assert ref.max_restart_fanout == 1       # JAX's fan-out knob unbound
    assert pat.HOST_PREFETCH == jcfg.DataConfig().prefetch == 2
    assert [f.name for f in dataclasses_fields(tcfg.AutotuneConfig)] == [
        "enabled"]
    assert tcfg.get_config("vggf_imagenet_dp").data.autotune == \
        tcfg.AutotuneConfig(enabled=True)
    cfg = tcfg.apply_overrides(tcfg.get_config("vggf_imagenet_dp"),
                               {"data.autotune.enabled": "false"})
    assert not cfg.data.autotune.enabled
    for key, value in (("data.autotune.k_windows", "5"),
                       ("data.autotune.max_prefetch", "3"),
                       ("data.autotune.max_restart_fanout", "4"),
                       ("data.prefetch", "4")):
        jcfg.apply_overrides(jcfg.get_config("vggf_imagenet_dp"),
                             {key: value})
        with pytest.raises(KeyError, match="ROADMAP A14b"):
            tcfg.apply_overrides(tcfg.get_config("vggf_imagenet_dp"),
                                 {key: value})


class FakeLoader:
    def __init__(self, n=4, refuse=False):
        self.n, self.refuse = n, refuse

    def num_threads(self):
        return self.n

    def set_num_threads(self, n):
        if self.refuse:
            return None
        self.n = n
        return n


def test_knob_factories():
    k = pat.thread_knob(FakeLoader(4), min_value=1, max_value=8)
    assert (k.name, k.geometric, k.min_value, k.max_value) == \
        ("native_threads", True, 1, 8)
    assert pat.thread_knob(FakeLoader(refuse=True)) is None
    assert pat.thread_knob(object()) is None
    assert pat.host_prefetch_knob(None) is None
    assert pat.device_ring_knob(object()) is None
    stage = FakeLoader(2)
    stage.depth, stage.set_depth = 2, stage.set_num_threads
    hp = pat.host_prefetch_knob(stage)
    assert (hp.name, hp.get(), hp.min_value, hp.max_value) == \
        ("host_prefetch", 2, 1, 8)
