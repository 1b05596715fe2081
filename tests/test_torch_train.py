"""The training path of the port against the reference, on the CPU:
K5's and K6's gradients, ``Model.loss`` (with and without ``gw_align``),
``launch.steps.make_train_step``, ``launch.train.train`` and its watchdog.

Inputs are made from numpy seeds; the model runs on the reference's own
``init(PRNGKey(0))`` weights carried across by ``model_params_from_jax``,
and where the reference draws the alignment tokens with threefry
(``fold_in(PRNGKey(17), step)``, split per example) the draws are
reproduced here with jax and injected (``gw_draws``). The reference's
jitted runs are shared through module-scoped fixtures. Tolerances, and
why:

* K5 and K6's wrappers against ``jax.grad`` of ``blockwise_gqa`` and of
  the reference's intra-chunk block: |diff| <= 1e-5·|want| + 1e-6 of the
  gradient's largest entry. On the CPU the wrappers' forward is the
  plain version; what is held is the plain backward of their
  ``autograd.Function`` (sum order only).
* the step-0 loss: rtol 1e-5; its gradient: |diff| <= 1e-4 of each
  leaf's largest entry + 1e-6 (the repo's bound on gradients against
  ``jax.grad``, tests/test_torch_diff.py; the stack of ~40 ops on each
  side, then the backward; measured <= 3.3e-6 of the largest entry);
  5-step ``loss``, ``ce``, ``gnorm``, ``lr``: rtol 1e-4.
  Parameters after several AdamW steps are not compared: m/√v turns a
  rounding-level gradient difference on a near-zero entry into a sign.
* ``remat``, a resumed run and the watchdog: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.kernels.ssd.ref import ssd_intra_ref as ref_intra
from repro.launch import steps as ref_steps
from repro.launch import train as ref_train
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro.models import ssm as ref_ssm
from repro.optim import adamw as ref_adamw
from repro_torch.configs import base as configs
from repro_torch.data import TokenPipeline
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.ssd.ops import ssd_intra
from repro_torch.launch import steps, train
from repro_torch.models import Model, ssm
from repro_torch.models.interop import model_params_from_jax
from repro_torch.optim import adamw
from test_torch_solve import _one_torch_thread  # noqa: F401 — autouse

KERNEL_RTOL, KERNEL_ATOL_REL = 1e-5, 1e-6
LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ATOL = 1e-4, 1e-6
HISTORY_RTOL = 1e-4
ARCH = "smollm_135m"
B, S = 2, 32                 # Model.loss / make_train_step parity batch
HISTORY_STEPS = 5


def _as_f64(got, want):
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    return got, want


def _grad_close(got, want, rtol, atol_rel):
    """|got - want| <= rtol·|want| + atol_rel·max|want| everywhere."""
    got, want = _as_f64(got, want)
    bound = rtol * np.abs(want) + atol_rel * np.abs(want).max()
    worst = (np.abs(got - want) - bound).max()
    assert worst <= 0, f"exceeds the bound by {worst:.3g}"


def _grad_within(got, want, rel=GRAD_REL, atol=GRAD_ATOL):
    """|got - want| <= rel·max|want| + atol everywhere."""
    got, want = _as_f64(got, want)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + atol, \
        f"max |diff| {err:.3g}, {err / np.abs(want).max():.3g} of the max"


# ---------------------------------------------------------------------------
# K5 and K6: the autograd.Functions' backward against jax.grad
# ---------------------------------------------------------------------------

# (B, S, K, G, hd, backward chunk): the reference's sweep widths, a
# ragged S = 200 over chunks of 48 (a ragged last chunk of 8) and over
# one chunk, and zamba2-7b's head dim 112 at 2 kv heads of 2 groups
K5_CASES = [(2, 64, 2, 3, 16, None), (1, 200, 1, 4, 8, 48),
            (1, 200, 2, 2, 16, None), (1, 96, 2, 2, 112, 32)]


@pytest.mark.parametrize("case", K5_CASES)
def test_flash_attention_grad_matches_blockwise_gqa(case, monkeypatch):
    Bq, Sq, K, G, hd, chunk = case
    if chunk:
        monkeypatch.setattr(fa, "BACKWARD_CHUNK", chunk)
    rng = np.random.default_rng(Sq + hd)
    q = rng.standard_normal((Bq, Sq, K * G, hd)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, K, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, K, hd)).astype(np.float32)
    w = rng.standard_normal((Bq, Sq, K * G, hd)).astype(np.float32)

    def ref_loss(q, k, v):
        out = ref_attention.blockwise_gqa(q.reshape(Bq, Sq, K, G, hd), k, v)
        return jnp.sum(out.reshape(Bq, Sq, K * G, hd) * w)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(q, k, v)
    got = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = flash_attention(*got, device="cpu")
    (out * torch.tensor(w)).sum().backward()
    for x, g in zip(got, want):
        _grad_close(x.grad, g, KERNEL_RTOL, KERNEL_ATOL_REL)


def test_flash_attention_backward_keeps_one_chunk_of_scores():
    """The chunked backward gives the same gradient for every chunk size
    (within sum order) and the plain backward's result in bfloat16."""
    g = torch.Generator().manual_seed(0)
    q, k, v, cot = (torch.randn(sh, generator=g) for sh in
                    ((6, 130, 16), (2, 130, 16), (2, 130, 16), (6, 130, 16)))
    whole = fa.flash_attention_backward_plain(q, k, v, 3, cot, chunk=130)
    for chunk in (1, 7, 64):
        parts = fa.flash_attention_backward_plain(q, k, v, 3, cot,
                                                  chunk=chunk)
        for a, b in zip(parts, whole):
            _grad_close(a, b.numpy(), KERNEL_RTOL, KERNEL_ATOL_REL)
    bf = fa.flash_attention_backward_plain(q.bfloat16(), k.bfloat16(),
                                           v.bfloat16(), 3, cot.bfloat16())
    assert all(x.dtype == torch.bfloat16 for x in bf)


def test_flash_attention_no_grad_path_unchanged():
    """Under no_grad (prefill, decode, gw_similarity) the wrapper is the
    plain forward, bit for bit, and its output has no graph."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(sh, generator=g) for sh in
               ((4, 40, 8), (2, 40, 8), (2, 40, 8)))
    with torch.no_grad():
        out = fa.flash_attention_cuda(q.requires_grad_(), k, v, 2)
    assert out.grad_fn is None
    assert torch.equal(out, fa.flash_attention_plain(q.detach(), k, v, 2))
    out = fa.flash_attention_cuda(q, k, v, 2)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(),
                       fa.flash_attention_plain(q.detach(), k, v, 2))


SSD_CASES = [(2, 32, 8, 16, 8), (3, 16, 4, 8, 6), (1, 128, 3, 64, 64)]


@pytest.mark.parametrize("shape", SSD_CASES)
def test_ssd_intra_grad_matches_reference(shape):
    G, k, H, P, N = shape
    rng = np.random.default_rng(sum(shape))
    xdt = rng.standard_normal((G, k, H, P)).astype(np.float32)
    cs = -np.cumsum(rng.random((G, k, H)), axis=1).astype(np.float32)
    Bm = rng.standard_normal((G, k, N)).astype(np.float32)
    Cm = rng.standard_normal((G, k, N)).astype(np.float32)
    w = rng.standard_normal((G, k, H, P)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax.vmap(ref_intra)(*a) * w),
                    argnums=(0, 1, 2, 3))(xdt, cs, Bm, Cm)
    got = [torch.tensor(x, requires_grad=True) for x in (xdt, cs, Bm, Cm)]
    out = ssd_intra(*got, device="cpu")
    (out * torch.tensor(w)).sum().backward()
    for x, g in zip(got, want):
        _grad_close(x.grad, g, KERNEL_RTOL, KERNEL_ATOL_REL)
    # only the inputs that ask for a gradient get one
    part = [torch.tensor(xdt, requires_grad=True)] + [
        torch.tensor(x) for x in (cs, Bm, Cm)]
    y = ssd.ssd_intra_cuda(*part)
    assert type(y.grad_fn).__name__ == "SsdIntraBackward"
    (y * torch.tensor(w)).sum().backward()
    _grad_close(part[0].grad, want[0], KERNEL_RTOL, KERNEL_ATOL_REL)
    with torch.no_grad():
        assert ssd.ssd_intra_cuda(*got).grad_fn is None


def test_ssd_intra_grad_finite_where_the_reference_overflows():
    """Decays summing past float32's exp range within a chunk (as at
    zamba2-7b's widths): the reference's float32 gradient is NaN (it
    takes exp above the diagonal, then masks), the port's is finite and
    within the kernel bound of the reference's gradient in x64."""
    G, k, H, P, N = 2, 64, 3, 8, 6
    rng = np.random.default_rng(9)
    xdt = rng.standard_normal((G, k, H, P)).astype(np.float32)
    cs = -np.cumsum(2.0 + rng.random((G, k, H)), axis=1).astype(np.float32)
    Bm = rng.standard_normal((G, k, N)).astype(np.float32)
    Cm = rng.standard_normal((G, k, N)).astype(np.float32)
    w = rng.standard_normal((G, k, H, P)).astype(np.float32)
    assert (cs[:, 0] - cs[:, -1]).min() > 89.0      # exp(89) > float32 max

    def ref_grad(*a):
        return jax.grad(lambda *x: jnp.sum(jax.vmap(ref_intra)(*x) * a[-1]),
                        argnums=(0, 1, 2, 3))(*a[:4])

    assert np.isnan(np.asarray(ref_grad(xdt, cs, Bm, Cm, w)[1])).any()
    with jax.enable_x64(True):
        want = [np.asarray(g) for g in ref_grad(
            *(jnp.asarray(x, jnp.float64) for x in (xdt, cs, Bm, Cm, w)))]
    got = [torch.tensor(x, requires_grad=True) for x in (xdt, cs, Bm, Cm)]
    (ssd_intra(*got, device="cpu") * torch.tensor(w)).sum().backward()
    for x, g in zip(got, want):
        _grad_close(x.grad, g, KERNEL_RTOL, KERNEL_ATOL_REL)


def test_ssd_chunked_grad_matches_reference():
    """The whole chunked SSD (intra block through K6's Function, the chunk
    scan and the inter term in torch) against jax.grad of the
    reference's ``_ssd_chunked``."""
    Bs, L, H, P, N, chunk = 2, 32, 4, 8, 6, 8
    rng = np.random.default_rng(3)
    xh = rng.standard_normal((Bs, L, H, P)).astype(np.float32)
    dt = (0.1 + rng.random((Bs, L, H))).astype(np.float32)
    a_log = (0.3 * rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((Bs, L, N)).astype(np.float32)
    Cm = rng.standard_normal((Bs, L, N)).astype(np.float32)
    w = rng.standard_normal((Bs, L, H, P)).astype(np.float32)

    def ref_loss(*a):
        return jnp.sum(ref_ssm._ssd_chunked(*a[:3], a[3], a[4], chunk)[0] * w)

    want = jax.grad(ref_loss, argnums=tuple(range(5)))(xh, dt, a_log, Bm, Cm)
    got = [torch.tensor(x, requires_grad=True)
           for x in (xh, dt, a_log, Bm, Cm)]
    y, _ = ssm._ssd_chunked(*got, chunk=chunk)
    (y * torch.tensor(w)).sum().backward()
    for x, g in zip(got, want):
        _grad_close(x.grad, g, KERNEL_RTOL, KERNEL_ATOL_REL)


# ---------------------------------------------------------------------------
# Model.loss and make_train_step against the reference
# ---------------------------------------------------------------------------

def _ref_gw_draws(step, Bn, Sn, s_r=64, s_c=64):
    """The reference's alignment draws at ``step``: ``fold_in(PRNGKey(17),
    step)``, split per example, each split into its row and col keys."""
    key = jax.random.fold_in(jax.random.PRNGKey(17), step)
    R, C = [], []
    for k in jax.random.split(key, Bn):
        kr, kc = jax.random.split(k)
        R.append(np.asarray(jax.random.randint(kr, (s_r,), 0, Sn)))
        C.append(np.asarray(jax.random.randint(kc, (s_c,), 0, Sn)))
    return np.stack(R), np.stack(C)


@pytest.fixture(scope="module")
def smollm():
    rcfg = ref_configs.get_reduced(ARCH)
    rmodel = ref_build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    cfg = configs.get_reduced(ARCH)
    params = model_params_from_jax(cfg, jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    batches = [TokenPipeline(cfg, S, B).global_batch_at(i)
               for i in range(HISTORY_STEPS)]
    return dict(rcfg=rcfg, rmodel=rmodel, rparams=rparams, cfg=cfg,
                params=params, batches=batches)


LOSS_CASES = {"ce_flash": dict(use_flash=True, gw_align=False),
              "ce_scores": dict(use_flash=False, gw_align=False),
              "gw_align_flash": dict(use_flash=True, gw_align=True)}


@pytest.fixture(scope="module")
def ref_losses(smollm):
    """Per case the reference's step-0 loss, ce and jax.grad, on batch 0
    with the step-0 key."""
    out = {}
    batch = jax.tree.map(jnp.asarray, smollm["batches"][0])
    gw_key = jax.random.fold_in(jax.random.PRNGKey(17), 0)
    for name, case in LOSS_CASES.items():
        def loss_fn(p, case=case):
            return smollm["rmodel"].loss(p, batch, act_dtype=jnp.float32,
                                         gw_key=gw_key, **case)

        (loss, parts), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(smollm["rparams"])
        out[name] = (float(loss), float(parts["ce"]),
                     jax.tree.map(np.asarray, grads))
    return out


def _port_loss(smollm, case, remat=False, params=None):
    live = adamw.tree_map(lambda t: t.clone().requires_grad_(True),
                          params or smollm["params"])
    draws = _ref_gw_draws(0, B, S) if case["gw_align"] else None
    loss, parts = Model(smollm["cfg"]).loss(
        live, smollm["batches"][0], remat=remat, gw_draws=draws,
        device="cpu", **case)
    grads = torch.autograd.grad(loss, adamw.tree_leaves(live))
    return loss, parts, grads


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_loss_and_grads_match_reference(smollm, ref_losses, name):
    loss, parts, grads = _port_loss(smollm, LOSS_CASES[name])
    rloss, rce, rgrads = ref_losses[name]
    np.testing.assert_allclose(float(loss.detach()), rloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["ce"].detach()), rce,
                               rtol=LOSS_RTOL)
    assert float(parts["aux"]) == 0.0
    want = model_params_from_jax(smollm["cfg"], rgrads, device="cpu")
    grads = iter(grads)
    got = adamw.tree_map(lambda p: next(grads), smollm["params"])
    for path, g, w in _pairs(got, want):
        try:
            _grad_within(g, w.numpy())
        except AssertionError as e:
            raise AssertionError(f"{path}: {e}") from None


def _pairs(got, want, path=""):
    """(path, got leaf, want leaf) over ``got``'s structure, ``want``
    indexed by the same keys."""
    if isinstance(got, dict):
        return [t for k in got for t in _pairs(got[k], want[k],
                                                 f"{path}/{k}")]
    if isinstance(got, (list, tuple)):
        return [t for i in range(len(got))
                for t in _pairs(got[i], want[i], f"{path}/{i}")]
    return [(path, got, want)]


@pytest.mark.parametrize("arch", [ARCH, "zamba2_7b"])
def test_remat_is_bitwise(arch):
    """remat=True recomputes each superblock in the backward: the same
    loss and gradient, bit for bit, through K5's and K6's Functions."""
    cfg = configs.get_reduced(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    batch = TokenPipeline(cfg, 16, 2).global_batch_at(0)
    out = []
    for remat in (False, True):
        live = adamw.tree_map(lambda t: t.clone().requires_grad_(True),
                              params)
        loss, _ = model.loss(live, batch, use_flash=True, remat=remat,
                             gw_align=True,
                             gw_generator=torch.Generator().manual_seed(3),
                             device="cpu")
        out.append((loss, torch.autograd.grad(loss, adamw.tree_leaves(live))))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


HISTORY_CASES = {"ce": False, "gw_align": True}


@pytest.fixture(scope="module")
def ref_histories(smollm):
    """The reference's make_train_step (jitted, float32, remat, flash) for
    5 steps from its init, per case: metrics per step."""
    out = {}
    for name, gw in HISTORY_CASES.items():
        step_fn = jax.jit(ref_steps.make_train_step(
            smollm["rmodel"], act_dtype=jnp.float32, remat=True,
            use_flash=True, gw_align=gw, warmup=2, total_steps=10))
        params = smollm["rparams"]
        state = ref_adamw.init(params)
        hist = []
        for batch in smollm["batches"]:
            params, state, m = step_fn(params, state,
                                       jax.tree.map(jnp.asarray, batch))
            hist.append({k: float(v) for k, v in m.items()})
        out[name] = hist
    return out


@pytest.mark.parametrize("name", list(HISTORY_CASES))
def test_train_step_history_matches_reference(smollm, ref_histories, name):
    gw = HISTORY_CASES[name]
    step_fn = steps.make_train_step(Model(smollm["cfg"]),
                                    act_dtype=torch.float32, remat=True,
                                    use_flash=True, gw_align=gw, warmup=2,
                                    total_steps=10)
    params = smollm["params"]
    state = adamw.init(params)
    for i, (batch, want) in enumerate(zip(smollm["batches"],
                                          ref_histories[name])):
        draws = _ref_gw_draws(i, B, S) if gw else None
        new, state, m = step_fn(params, state, batch, gw_draws=draws)
        assert all(not p.requires_grad for p in adamw.tree_leaves(new))
        params = new
        for key in ("loss", "ce", "gnorm", "lr"):
            np.testing.assert_allclose(float(m[key]), want[key],
                                       rtol=HISTORY_RTOL, err_msg=key)
        assert float(m["aux"]) == want["aux"] == 0.0
    assert int(state.step) == HISTORY_STEPS


def test_train_step_draws_from_the_step_seed(smollm):
    """Without injected draws a step seeds its alignment draws from
    (17, step): the same step draws the same tokens, another step others."""
    step_fn = steps.make_train_step(Model(smollm["cfg"]),
                                    act_dtype=torch.float32, use_flash=True,
                                    gw_align=True)
    state = adamw.init(smollm["params"])
    batch = smollm["batches"][0]
    runs = [step_fn(smollm["params"], s, batch)[2]["loss"]
            for s in (state, state, state._replace(
                step=torch.ones((), dtype=torch.int32)))]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                             runs[2])
    assert steps.gw_seed(5) == (17 << 32) + 5


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_one_train_step_every_ported_arch(arch):
    cfg = configs.get_reduced(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    seq = 2 * (cfg.ssm_chunk or 8)
    batch = TokenPipeline(cfg, seq, 2).global_batch_at(0)
    step_fn = steps.make_train_step(model, act_dtype=torch.float32,
                                    use_flash=True, gw_align=True)
    new, state, m = step_fn(params, adamw.init(params), batch)
    assert np.isfinite(float(m["loss"])) and float(m["gnorm"]) > 0
    assert int(state.step) == 1
    changed = [not torch.equal(a, b) for a, b in
               zip(adamw.tree_leaves(params), adamw.tree_leaves(new))]
    assert all(changed)


def test_prefill_and_decode_steps_call_the_model(smollm):
    model = Model(smollm["cfg"])
    batch = smollm["batches"][0]
    logits, cache = steps.make_prefill_step(model, torch.float32)(
        smollm["params"], batch)
    want, _ = model.prefill(smollm["params"], torch.as_tensor(
        batch["tokens"]), act_dtype=torch.float32, device="cpu")
    assert torch.equal(logits, want)
    c0 = model.init_cache(B, 4, dtype=torch.float32, device="cpu")
    lg, _ = steps.make_decode_step(model, torch.float32)(
        smollm["params"], {"tokens": batch["tokens"][:, :1], "cache": c0,
                           "index": 0})
    assert tuple(lg.shape) == (B, 1, smollm["cfg"].vocab_size)


# ---------------------------------------------------------------------------
# the train loop
# ---------------------------------------------------------------------------

def test_training_reduces_loss():
    """tests/test_system.py's run: 60 steps, batch 8 x 64, lr 3e-3."""
    cfg = configs.get_reduced(ARCH)
    _, _, hist = train.train(cfg, 60, 8, 64, ckpt_dir=None, log_every=0,
                             base_lr=3e-3, device="cpu")
    first = np.mean([h["ce"] for h in hist[:5]])
    last = np.mean([h["ce"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)


def test_resume_is_bit_exact(tmp_path):
    """tests/test_elastic.py's run, with flash attention and the alignment
    loss on: 8 steps straight against 4 steps, a checkpoint, a restart
    and 4 more (the same 8-step schedule)."""
    cfg = configs.get_reduced(ARCH)
    kw = dict(log_every=0, device="cpu", use_flash=True, gw_align=True)
    pa, _, hist_a = train.train(cfg, 8, 4, 32, ckpt_dir=None, **kw)
    ck = str(tmp_path / "ck")
    train.train(cfg, 4, 4, 32, ckpt_dir=ck, ckpt_every=4, schedule_total=8,
                **kw)
    pb, sb, hist_b = train.train(cfg, 8, 4, 32, ckpt_dir=ck, ckpt_every=4,
                                 **kw)
    assert [h["loss"] for h in hist_a[4:]] == [h["loss"] for h in hist_b]
    assert all(torch.equal(a, b) for a, b in
               zip(adamw.tree_leaves(pa), adamw.tree_leaves(pb)))
    assert int(sb.step) == 8
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [4, 8]
    _, extra = mgr.restore(8, {})
    assert extra["pipeline"]["step"] == 8


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    params, state, hist = train.main([
        "--arch", "smollm-135m", "--reduced", "--device", "cpu", "--steps",
        "3", "--batch", "2", "--seq", "16", "--use-flash", "--gw-align",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert len(hist) == 3 and int(state.step) == 3
    assert "step     0 loss" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000002", "step_0000000003"]


def test_train_raises_without_a_card_or_with_a_mesh(monkeypatch):
    cfg = configs.get_reduced(ARCH)
    # a mesh needs the default process group it is built over
    with pytest.raises(ValueError, match="process group"):
        train.train(cfg, 1, 2, 8, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train(cfg, 1, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg).loss({}, {"tokens": np.zeros((1, 2), np.int32),
                             "labels": np.zeros((1, 2), np.int32)})


def test_loss_needs_draws_for_gw_align(smollm):
    with pytest.raises(ValueError, match="gw_generator or gw_draws"):
        Model(smollm["cfg"]).loss(smollm["params"], smollm["batches"][0],
                                  gw_align=True, device="cpu")


def test_straggler_watchdog_detects():
    """tests/test_elastic.py's check, on both watchdogs."""
    for cls in (train.StragglerWatchdog, ref_train.StragglerWatchdog):
        wd = cls(factor=2.0)
        for _ in range(5):
            wd.observe(0, 0.1)
        assert wd.observe(6, 0.5)
        assert not wd.observe(7, 0.11)
        assert len(wd.events) == 1
    a, b = train.StragglerWatchdog(), ref_train.StragglerWatchdog()
    for i, dt in enumerate((0.3, 0.2, 0.9, 0.25, 0.1, 0.7)):
        assert a.observe(i, dt) == b.observe(i, dt)
    assert a.events == b.events and a.ema == b.ema


def test_alignment_gradient_overflow_is_the_references():
    """A fault of the reference, reproduced: where the unrolled Sinkhorn's
    denominators fall low, the float32 backward of ``num / den`` overflows
    and meets a flushed kernel entry (inf·0), and the alignment loss's
    gradient is NaN on both sides; in float64 both are finite and agree.
    (On the card smollm-135m can meet it above the default learning
    rate.)"""
    from repro.core.grid_gw import grid_spar_gw_differentiable as j_diff
    from repro.core import align as j_align
    from repro_torch.core import align

    rng = np.random.default_rng(8)
    hx, hy = ((rng.standard_normal((64, 2)) @ rng.standard_normal((2, 32)))
              .astype(np.float32) for _ in range(2))

    def ref(dt):
        def loss(x, y):
            xn = x / (jnp.linalg.norm(x, axis=-1, keepdims=True) + 1e-6)
            yn = y / (jnp.linalg.norm(y, axis=-1, keepdims=True) + 1e-6)
            a = jnp.full((64,), 1 / 64, dt)
            return j_diff(a, a, j_align._pairwise_sq_dists(xn),
                          j_align._pairwise_sq_dists(yn), a, a,
                          jnp.ones((64, 64), dt), "l2", 0.05, 3, 10)[0]
        return jax.jit(jax.grad(loss, argnums=(0, 1)))(
            jnp.asarray(hx, dt), jnp.asarray(hy, dt))

    def port(dtype):
        x, y = (torch.tensor(h[None], dtype=dtype, requires_grad=True)
                for h in (hx, hy))
        every = (np.arange(64)[None], np.arange(64)[None])
        return torch.autograd.grad(
            align.gw_alignment_loss(None, x, y, draws=every), (x, y))

    assert np.isnan(np.asarray(ref(jnp.float32)[0])).any()
    assert any(bool(g.isnan().any()) for g in port(torch.float32))
    with jax.enable_x64(True):
        want = ref(jnp.float64)
    for got, w in zip(port(torch.float64), want):
        _grad_close(got[0], np.asarray(w), KERNEL_RTOL, KERNEL_ATOL_REL)


def test_training_modules_import_alone():
    """The training modules import in a fresh process without JAX or the
    reference, and resolve the two configs this slice adds."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import repro_torch.data, repro_torch.checkpoint\n"
        "import repro_torch.launch.steps, repro_torch.launch.train\n"
        "from repro_torch.configs import get_arch\n"
        "assert get_arch('smollm-135m').d_model == 576\n"
        "assert get_arch('phi4-mini-3.8b').vocab_size == 200064\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
