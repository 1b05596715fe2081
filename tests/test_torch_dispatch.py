"""The port's kernel dispatch against ``repro.kernels.dispatch``, on the CPU.

Each test runs the same sequence of calls on both sides: the block-size
resolution order with an autotune cache, ``autotune`` (winner, records,
gauges), the resolution counter, the records' dump, the padding helpers,
and the small helpers of ``core/utils``, ``models/layers`` and
``models/module``. Families are the test's own (``_t25_*``); both
autotune caches are cleared after each test, since other files that share
the worker expect the registry defaults (``spar_cost`` at 256).

Tolerances: the padding helpers bitwise; ``chunked_rows``, ``total_mass``
and ``unembed`` 1e-5 of the largest output (the stack checks' bound:
XLA's CPU matmul and sums differ from torch's by a few ulp).
"""
import dataclasses
import importlib
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.dispatch as jd
from repro.models import layers as jlayers
from repro.models import module as jmodule
from repro.obs.registry import registry as jregistry
from repro_torch.kernels import dispatch as pd
from repro_torch.models import layers as players
from repro_torch.models import module as pmodule
from repro_torch.obs.registry import registry as pregistry

jutils = importlib.import_module("repro.core.utils")
putils = importlib.import_module("repro_torch.core.utils")

SIDES = ((jd, jregistry, jnp.asarray), (pd, pregistry, torch.as_tensor))
FAMILIES = ("_t25_order", "_t25_unreg", "_t25_tune", "_t25_skip",
            "_t25_none", "_t25_raise", "_t25_dump")
SLEEP_S = 0.02
STACK_REL = 1e-5


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for fam in FAMILIES:
        monkeypatch.delenv(f"REPRO_BLOCK_{fam.upper()}", raising=False)
    yield
    jd.clear_autotune_cache()
    pd.clear_autotune_cache()


def _bench(array, slow=(), refuse=(), error=None):
    """A bench that sleeps for the blocks in ``slow``, raises ValueError
    (an argument check's refusal) for those in ``refuse``, ``error`` for
    any other block if given, and returns a small array otherwise."""
    def fn(block):
        if block in refuse:
            raise ValueError(f"block {block} refused")
        if error is not None:
            raise error
        if block in slow:
            time.sleep(SLEEP_S)
        return array(np.zeros(4, np.float32))
    return fn


def _series(reg, name, prefix="_t25_"):
    """{labels: value} of a metric's series whose family starts with
    ``prefix``, and the metric's type and help text."""
    fam = reg().snapshot()["metrics"].get(name)
    if fam is None:
        return None
    rows = {tuple(sorted(r["labels"].items())): r["value"]
            for r in fam["series"]
            if r["labels"].get("family", "").startswith(prefix)}
    return fam["type"], fam["help"], rows


def _resolution_sequence(mod, array, monkeypatch):
    mod.register("_t25_order", 64, "test family")
    out = [mod.block_size("_t25_order")]                  # default
    monkeypatch.setenv("REPRO_BLOCK__T25_ORDER", "48")
    out.append(mod.block_size("_t25_order"))              # env
    out.append(mod.autotune("_t25_order", (16, 32),
                            _bench(array, slow=(16,))))
    out.append(mod.block_size("_t25_order"))              # env over cache
    monkeypatch.delenv("REPRO_BLOCK__T25_ORDER")
    out.append(mod.block_size("_t25_order"))              # autotune
    out.append(mod.block_size("_t25_order", 8))           # override
    out.append(mod.block_size("_t25_order", cap=20))      # cap on the cache
    out.append(mod.block_size("_t25_order", 8, cap=4))
    out.append(mod.block_size("_t25_order", cap=0))       # >= 1
    out.append(mod.block_size("_t25_unreg"))              # 128
    out.append(mod.autotune("_t25_unreg", (24, 40),
                            _bench(array, slow=(24,))))
    out.append(mod.block_size("_t25_unreg"))
    return out


def test_resolution_order_and_counter_match_the_reference(monkeypatch):
    name = "repro_kernel_block_resolutions_total"
    got = []
    for mod, reg, array in SIDES:
        before = _series(reg, name)
        before = before[2] if before else {}
        seq = _resolution_sequence(mod, array, monkeypatch)
        typ, help_, after = _series(reg, name)
        delta = {k: v - before.get(k, 0.0) for k, v in after.items()}
        got.append((seq, typ, help_, {k: v for k, v in delta.items() if v}))
    assert got[1] == got[0]
    seq, typ, _, delta = got[1]
    assert seq == [64, 48, 32, 48, 32, 8, 20, 4, 1, 128, 40, 40]
    assert typ == "counter"
    fam = {"family": "_t25_order"}
    assert delta == {
        tuple(sorted({**fam, "source": "default"}.items())): 1.0,
        tuple(sorted({**fam, "source": "env"}.items())): 2.0,
        tuple(sorted({**fam, "source": "autotune"}.items())): 3.0,
        tuple(sorted({**fam, "source": "override"}.items())): 2.0,
        (("family", "_t25_unreg"), ("source", "default")): 1.0,
        (("family", "_t25_unreg"), ("source", "autotune")): 1.0}
    assert dataclasses.asdict(pd.registry()["_t25_order"]) == \
        dataclasses.asdict(jd.registry()["_t25_order"])
    pd.registry().pop("_t25_order")                 # a copy: no effect
    assert "_t25_order" in pd.registry()


def test_autotune_records_and_gauges_match_the_reference():
    records = []
    for mod, _, array in SIDES:
        best = mod.autotune("_t25_tune", (8, 16, 32),
                            _bench(array, slow=(8, 16)), reps=2,
                            flops_per_call=2e6, bytes_per_call=4e6)
        assert best == 32 and mod.block_size("_t25_tune") == 32
        rec = mod.autotune_records()[-1]
        assert set(rec["timings_s"]) == {"8", "16", "32"}
        assert rec["timings_s"]["8"] >= SLEEP_S > rec["timings_s"]["32"]
        records.append({k: v for k, v in rec.items()
                        if k not in ("timings_s", "gflops", "gbytes_per_s")}
                       | {"keys": sorted(rec)})
    assert records[1] == records[0]
    assert records[1]["backend"] == "cpu"
    for name in ("repro_autotune_best_block",
                 "repro_autotune_best_time_seconds",
                 "repro_autotune_gflops", "repro_autotune_gbytes_per_s"):
        (jt, jh, jrows), (pt, ph, prows) = (_series(reg, name, "_t25_tune")
                                            for _, reg, _ in SIDES)
        assert (pt, ph, set(prows)) == (jt, jh, set(jrows)) == (
            "gauge", jh, {(("backend", "cpu"), ("family", "_t25_tune"))})
        if name == "repro_autotune_best_block":
            assert list(prows.values()) == list(jrows.values()) == [32.0]


def test_autotune_skips_a_refused_block_and_keeps_the_cache():
    for mod, _, array in SIDES:
        assert mod.autotune("_t25_skip", (8, 16, 32),
                            _bench(array, slow=(16,), refuse=(32,))) == 8
        assert set(mod.autotune_records()[-1]["timings_s"]) == {"8", "16"}
        # every candidate refused: None, the cache and records unchanged
        n = len(mod.autotune_records())
        assert mod.autotune("_t25_skip", (32, 64),
                            _bench(array, refuse=(32, 64))) is None
        assert mod.block_size("_t25_skip") == 8
        assert len(mod.autotune_records()) == n
        assert mod.autotune("_t25_none", (), _bench(array)) is None
        assert mod.block_size("_t25_none") == 128


def test_autotune_raises_what_is_not_a_refusal():
    """The port's departure: a sweep must not hide a kernel that does not
    build or launch, so any error but the argument check's ValueError is
    raised. The reference skips every exception (it returns None here),
    so only the port is held to this."""
    with pytest.raises(RuntimeError, match="launch failed"):
        pd.autotune("_t25_raise", (32,), _bench(
            torch.as_tensor, error=RuntimeError("launch failed")))
    assert jd.autotune("_t25_raise", (32,), _bench(
        jnp.asarray, error=RuntimeError("launch failed"))) is None
    assert pd.block_size("_t25_raise") == 128
    assert pd.autotune_records() == []


def test_dump_autotune_records_round_trips(tmp_path, monkeypatch):
    assert pd.dump_autotune_records(tmp_path / "none.json") is None
    dumped = []
    for mod, _, array in SIDES:
        mod.autotune("_t25_dump", (16, 32), _bench(array, slow=(16,)),
                     bytes_per_call=1e3)
        path = mod.dump_autotune_records(tmp_path / f"{mod.__name__}.json")
        recs = json.loads(path.read_text())
        assert recs == mod.autotune_records()
        dumped.append([{k: v for k, v in r.items() if k != "timings_s"
                        and k != "gbytes_per_s"} for r in recs])
    assert dumped[1] == dumped[0]
    monkeypatch.setattr(pd, "autotune_artifact_dir", lambda: tmp_path / "a")
    path = pd.dump_autotune_records()
    assert path == tmp_path / "a" / "torch-cpu.json"
    assert json.loads(path.read_text()) == pd.autotune_records()


def test_autotune_artifact_dir_is_the_reference_dir():
    assert pd.autotune_artifact_dir() == jd.autotune_artifact_dir()


PAD_CASES = [((5, 7), (4, 8)), ((8, 16), (4, 8)), ((3,), (2,)),
             ((2, 3, 5), (1, 4, 3))]


@pytest.mark.parametrize("shape,mults", PAD_CASES)
def test_padding_helpers_match_the_reference_bitwise(shape, mults):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    jx, px = jnp.asarray(x), torch.from_numpy(x.copy())
    (jp, jshape), (pp, pshape) = (jd.pad_to_multiple(jx, mults),
                                  pd.pad_to_multiple(px, mults))
    assert tuple(pshape) == tuple(jshape) == shape
    assert np.asarray(jp).tobytes() == pp.numpy().tobytes()
    assert tuple(pp.shape) == jp.shape
    aligned = all(d % m == 0 for d, m in zip(shape, mults))
    assert (pp is px) == aligned
    ju, pu = jd.unpad(jp, jshape), pd.unpad(pp, pshape)
    assert np.asarray(ju).tobytes() == pu.numpy().tobytes() == x.tobytes()
    assert pd.unpad(px, shape) is px
    axis = len(shape) - 1
    for mult, value in ((4, -1.5), (shape[axis], 7.0)):
        jq = jd.pad_dim(jx, mult, axis=axis, value=value)
        pq = pd.pad_dim(px, mult, axis=axis, value=value)
        assert np.asarray(jq).tobytes() == pq.numpy().tobytes()
        assert (pq is px) == (shape[axis] % mult == 0)
    jq, pq = jd.pad_dim(jx, 3), pd.pad_dim(px, 3)                 # axis 0
    assert np.asarray(jq).tobytes() == pq.numpy().tobytes()


def _close(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= STACK_REL * np.max(np.abs(want))


@pytest.mark.parametrize("n_rows,chunk", [(10, 4), (12, 4), (5, 8)])
def test_chunked_rows_and_total_mass_match_the_reference(n_rows, chunk):
    x = np.random.default_rng(n_rows).standard_normal((n_rows, 6)).astype(
        np.float32)
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    want = jutils.chunked_rows(
        lambda lo, size: jnp.exp(jx[lo:lo + size]) + lo, n_rows, chunk)
    got = putils.chunked_rows(
        lambda lo, size: torch.exp(px[lo:lo + size]) + lo, n_rows, chunk)
    _close(got, want)
    _close(putils.total_mass(got), jutils.total_mass(want))


def test_unembed_matches_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    head = rng.standard_normal((16, 40)).astype(np.float32)
    _close(players.unembed(torch.from_numpy(head), torch.from_numpy(x)),
           jlayers.unembed(jnp.asarray(head), jnp.asarray(x)))


def _init_fn(layers):
    def init(b, cfg):
        vocab, d, f = cfg
        return {"norm": layers.rmsnorm_params(b, d),
                "embed": layers.embed_params(b, vocab, d),
                "mlp": layers.mlp_params(b, d, f)}
    return init


def test_make_matches_the_reference_in_every_mode():
    """``axes`` and ``shape`` trees equal; ``init`` the same shapes and
    dtypes, the ``ones`` leaf equal, and each normal leaf drawn at the
    reference's scale (the draws themselves differ: threefry vs torch's
    generator). 16 384 draws a leaf estimate its deviation to ~0.6 %, so
    5 % is ~9 standard errors."""
    import jax

    cfg = (128, 64, 256)
    jinit, pinit = _init_fn(jlayers), _init_fn(players)
    assert pmodule.make(pinit, cfg, "axes") == jmodule.make(jinit, cfg,
                                                            "axes")
    js = jmodule.make(jinit, cfg, "shape")
    ps = pmodule.make(pinit, cfg, "shape")
    flat_j = {k: v for k, v in _flatten(js)}
    flat_p = {k: v for k, v in _flatten(ps)}
    assert set(flat_p) == set(flat_j)
    for k, leaf in flat_p.items():
        assert leaf.device.type == "meta"
        assert (tuple(leaf.shape), str(leaf.dtype).split(".")[-1]) == (
            flat_j[k].shape, str(flat_j[k].dtype))
    jw = dict(_flatten(jmodule.make(jinit, cfg, "init",
                                    key=jax.random.PRNGKey(0))))
    pw = dict(_flatten(pmodule.make(
        pinit, cfg, "init", generator=torch.Generator().manual_seed(0),
        device="cpu")))
    assert set(pw) == set(jw)
    for k, w in pw.items():
        want = np.asarray(jw[k])
        assert tuple(w.shape) == want.shape and w.dtype == torch.float32
        if k == "norm/scale":
            assert np.array_equal(w.numpy(), want)
        else:
            assert abs(float(w.std()) / float(want.std()) - 1) < 0.05, k
    bf = pmodule.make(pinit, cfg, "init", torch.Generator().manual_seed(0),
                      dtype=torch.bfloat16, device="cpu")
    assert bf["mlp"]["w_up"].dtype == torch.bfloat16


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_make_init_takes_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmodule.make(_init_fn(players), (8, 4, 8), "init",
                     torch.Generator().manual_seed(0))
    assert pd.backend() == "cpu"
