"""The rest of the flash kernels' domain: every head dim up to 256 in
bfloat16, float16 and float32, held against the JAX package.

The Pallas kernels take any float dtype and any head dim; the port routes
bfloat16 at D 64 and 128 to the Hopper kernels and every other call to the
general ones (``flash_cuda.route``).  On the CPU the wrappers run the plain
versions, which both routes share, so the same numpy inputs go through the
JAX ``_flash_forward`` / ``_flash_backward`` in Pallas interpret mode
(16-row blocks, so every case spans several q/k blocks) and through the
port.  Tolerances: float32 at the reference's own (tests/test_workloads.py:
forward atol 1e-5 / rtol 1e-4, gradients atol 1e-4 / rtol 1e-3); bfloat16
and float16 out atol / rtol 2e-2 and lse atol 1e-2 (p rounds to the input
type against the block's running max in the Pallas kernel and the row's
final max in the plain version), gradients max|err| <= 2e-2 max|ref| (the
same roundings of p and ds at other ulps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofa_tpu.workloads import flash_pallas as jfp
from sofa_tpu.workloads import transformer as jtr
from sofa_tpu_torch import convert, kernels
from sofa_tpu_torch import entry as tentry
from sofa_tpu_torch.workloads import flash_cuda as tfc
from sofa_tpu_torch.workloads import transformer as ttr

F32_ATOL, F32_RTOL = 1e-5, 1e-4
F32_GRAD_ATOL, F32_GRAD_RTOL = 1e-4, 1e-3
LOW_OUT_TOL, LOW_LSE_ATOL, LOW_GRAD_REL = 2e-2, 1e-2, 2e-2

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16),
          "f32": (torch.float32, jnp.float32)}


def _inputs(seed, b, t, h, kvh, d, tk=None):
    rng = np.random.default_rng(seed)
    tk = t if tk is None else tk
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, t, h, d), (b, tk, kvh, d), (b, tk, kvh, d),
                      (b, t, h, d))]


def _both(x, dtype):
    """One numpy array as the same values in torch and JAX at ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(x).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


# --- the route --------------------------------------------------------------

def test_route_covers_the_whole_domain():
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for d in range(1, tfc.MAX_HEAD_DIM + 1):
            got = list(tfc.route(dtype, d))
            hopper = dtype == torch.bfloat16 and d in (64, 128)
            assert got == (kernels.HOPPER if hopper else kernels.GENERAL), \
                (dtype, d)
            assert tfc.supports(1, d, dtype)
    assert [k.family for k in tfc.route(torch.float16, 64)] == \
        ["general"] * 3


@pytest.mark.parametrize("d", [0, 257, 320])
def test_route_refuses_head_dims_outside_1_to_256(d):
    with pytest.raises(ValueError, match=str(d)):
        tfc.route(torch.float32, d)
    assert not tfc.supports(16, d, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32,
                                   torch.float8_e4m3fn])
def test_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match=str(dtype).split(".")[-1]):
        tfc.route(dtype, 64)
    assert not tfc.supports(16, 64, dtype)


# --- the auto rule ----------------------------------------------------------

def test_auto_rule_sends_float32_and_d16_models_to_the_kernels():
    """``use_flash`` reads only the device's type, so a ``cuda`` device
    object decides on this CPU host what the card would run."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    f32 = dataclasses.replace(tentry.ENTRY_CONFIG, flash=None,
                              dtype=torch.float32)
    tiny = ttr.TransformerConfig.tiny(seq=128)
    f16 = dataclasses.replace(tiny, dtype=torch.float16)
    for cfg in (f32, tiny, f16):
        assert ttr.use_flash(cfg, 128, cuda) and not ttr.use_flash(cfg, 128,
                                                                   cpu)
    assert tiny.d_head == 16 and f32.d_head == 64
    assert tfc.route(f32.dtype, f32.d_head) == tuple(kernels.GENERAL)
    assert tfc.route(tiny.dtype, tiny.d_head) == tuple(kernels.GENERAL)


def test_auto_rule_and_flash_true_outside_the_domain():
    cuda = torch.device("cuda")
    wide = dataclasses.replace(ttr.TransformerConfig.tiny(seq=128),
                               d_model=640, n_heads=2, n_kv_heads=1)
    assert wide.d_head == 320
    assert not ttr.use_flash(wide, 128, cuda)           # auto: plain
    with pytest.raises(ValueError, match="320"):
        ttr.use_flash(dataclasses.replace(wide, flash=True), 128, cuda)
    f64 = dataclasses.replace(ttr.TransformerConfig.tiny(seq=128),
                              dtype=torch.float64, flash=True)
    with pytest.raises(TypeError, match="float64"):
        ttr.use_flash(f64, 128, cuda)
    assert not ttr.use_flash(dataclasses.replace(f64, flash=None), 128,
                             cuda)
    with pytest.raises(ValueError, match="seq len 0"):
        ttr.use_flash(dataclasses.replace(wide, d_model=64, flash=True), 0,
                      cuda)


# --- the plain versions against the Pallas kernels ---------------------------

CASES = [
    # id, dtype, (b, t, h, kvh, d, tk), shift, segmented
    ("f32_d32_causal_gqa2", "f32", (2, 48, 4, 2, 32, None), 0, False),
    ("f32_d80_ring_hop", "f32", (1, 32, 4, 2, 80, 48), 32, False),
    ("f32_d256_segmented", "f32", (1, 48, 4, 1, 256, None), 0, True),
    ("bf16_d16_causal_gqa4", "bf16", (2, 64, 8, 2, 16, None), 0, False),
    ("bf16_d256_causal", "bf16", (1, 48, 2, 1, 256, None), 0, False),
    ("f16_d16_segmented", "f16", (2, 64, 4, 2, 16, None), 0, True),
    ("f16_d256_shift_cut", "f16", (1, 48, 2, 2, 256, None), -5, False),
    # head dims whose rows are not a multiple of 16 bytes (the tensor-core
    # kernels' thread-by-thread loads on the card)
    ("bf16_d100_ring_hop_gqa2", "bf16", (1, 32, 4, 2, 100, 48), 32, False),
    ("f16_d7_segmented", "f16", (2, 48, 4, 2, 7, None), 0, True),
]


def _segments(b, t):
    seg = np.zeros((b, t), np.int32)
    seg[:, t // 3:] = 1
    seg[:, 3 * t // 4:] = 2
    return seg


@pytest.mark.parametrize("seed,dtype,shape,shift,segmented",
                         [(i, *c[1:]) for i, c in enumerate(CASES)],
                         ids=[c[0] for c in CASES])
def test_domain_matches_jax_interpret(seed, dtype, shape, shift, segmented):
    """Forward and backward (gradients in the input dtype, and in float32
    for the float32 cases) of the plain versions, which the general
    kernels compute, against the Pallas kernels."""
    b, t, h, kvh, d, tk = shape
    tk = t if tk is None else tk
    (tq, jq), (tk_, jk), (tv, jv), (tg, jg) = (
        _both(x, dtype) for x in _inputs(seed, b, t, h, kvh, d, tk))
    seg = _segments(b, t) if segmented else None
    jseg = None if seg is None else jnp.asarray(seg)
    tseg = None if seg is None else torch.from_numpy(seg)
    static = shift <= 0
    with jax.default_matmul_precision("highest"):
        j_out, j_lse = jfp._flash_forward(jq, jk, jv, shift, 16, 16, True,
                                          static_causal=static,
                                          segment_ids=jseg)
        j_grads = jfp._flash_backward(jq, jk, jv, jg, j_out, j_lse, shift,
                                      static_causal=static, block_q=16,
                                      block_k=16, interpret=True,
                                      segment_ids=jseg)
    out, lse = tfc._flash_forward(tq, tk_, tv, shift, static,
                                  segment_ids=tseg)
    grads = tfc._flash_backward(tq, tk_, tv, tg, out, lse, shift, static,
                                segment_ids=tseg)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    j_out = np.asarray(j_out.astype(jnp.float32))
    j_lse = np.asarray(j_lse)
    vis = np.broadcast_to(_visible(t, tk, shift, seg), lse.shape)
    if dtype == "f32":
        np.testing.assert_allclose(out.numpy(), j_out, atol=F32_ATOL,
                                   rtol=F32_RTOL)
        np.testing.assert_allclose(lse.numpy()[vis], j_lse[vis],
                                   atol=F32_ATOL, rtol=F32_RTOL)
    else:
        np.testing.assert_allclose(out.float().numpy(), j_out,
                                   atol=LOW_OUT_TOL, rtol=LOW_OUT_TOL)
        np.testing.assert_allclose(lse.numpy()[vis], j_lse[vis],
                                   atol=LOW_LSE_ATOL, rtol=0)
    assert (lse.numpy()[~vis] <= -1e29).all()
    for name, a, r in zip(("dq", "dk", "dv"), grads, j_grads):
        r = np.asarray(r.astype(jnp.float32))
        assert a.dtype == tq.dtype and tuple(a.shape) == r.shape, name
        a = a.float().numpy()
        if dtype == "f32":
            np.testing.assert_allclose(a, r, atol=F32_GRAD_ATOL,
                                       rtol=F32_GRAD_RTOL, err_msg=name)
        else:
            assert np.abs(a - r).max() <= LOW_GRAD_REL * np.abs(r).max(), \
                name
    if dtype == "f32":      # the float32 output mode the ring merges use
        with jax.default_matmul_precision("highest"):
            j32 = jfp._flash_backward(jq, jk, jv, jg, *jfp._flash_forward(
                jq, jk, jv, shift, 16, 16, True, static_causal=static,
                segment_ids=jseg), shift, static_causal=static,
                grad_dtype=jnp.float32, block_q=16, block_k=16,
                interpret=True, segment_ids=jseg)
        g32 = tfc._flash_backward(tq, tk_, tv, tg, out, lse, shift, static,
                                  grad_dtype=torch.float32, segment_ids=tseg)
        for a, r in zip(g32, j32):
            np.testing.assert_allclose(a.numpy(), np.asarray(r),
                                       atol=F32_GRAD_ATOL,
                                       rtol=F32_GRAD_RTOL)


def _visible(t, tk, shift, seg):
    """[B or 1, H broadcast, T] bool: rows that see at least one key."""
    keep = (np.arange(tk)[None, :] <= np.arange(t)[:, None] + shift)[None]
    if seg is not None:
        keep = keep & (seg[:, :, None] == seg[:, None, :])
    return keep.any(-1)[:, None, :]


def test_cpu_route_launches_no_kernel_in_any_dtype():
    """On the CPU every dtype of the domain runs the plain versions: no
    launch count moves."""
    before = kernels.counts()
    for dtype in ("bf16", "f16", "f32"):
        q, k, v, g = (_both(x, dtype)[0]
                      for x in _inputs(3, 1, 16, 2, 1, 24))
        q.requires_grad_(True)
        tfc.flash_causal_attention(q, k, v).float().sum().backward()
        assert q.grad.dtype == q.dtype
    assert kernels.counts() == before


# --- the float32 flagship ---------------------------------------------------

def test_float32_flagship_forward_matches_jax():
    """The flagship's widths (``entry.ENTRY_CONFIG``: vocab 8192, d_model
    512, 4 layers, 8 / 4 heads of 64) in float32, from the JAX package's
    init carried over (``convert.params_from_numpy``), at B 1, T 64: the
    fused path on both sides (the plain versions here, Pallas interpret
    mode there).  Tolerance atol / rtol 1e-4 (tests/test_torch_transformer
    .py's: float32 layers summed in other orders)."""
    tcfg = dataclasses.replace(tentry.ENTRY_CONFIG, dtype=torch.float32,
                               flash=True, max_seq=64)
    jcfg = jtr.TransformerConfig(vocab=tcfg.vocab, d_model=tcfg.d_model,
                                 n_layers=tcfg.n_layers,
                                 n_heads=tcfg.n_heads,
                                 n_kv_heads=tcfg.n_kv_heads, d_ff=tcfg.d_ff,
                                 max_seq=64, dtype=jnp.float32, flash=True)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab, (1, 64),
                                               dtype=np.int32)
    with jax.default_matmul_precision("highest"):
        ref = jtr.forward(jp, jnp.asarray(tokens), jcfg)
    got = ttr.forward(tp, torch.from_numpy(tokens).long(), tcfg)
    assert got.dtype == torch.float32 and got.shape == (1, 64, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


# --- costs and kernel_perf --------------------------------------------------

@pytest.mark.parametrize("itemsize", [2, 4])
def test_general_kernels_carry_their_pallas_calls_cost(itemsize):
    """A general kernel is credited with the Pallas call it ports, its
    bytes at the input's element size; a cost range named without one is a
    bfloat16 launch's (the names before the general kernels)."""
    from sofa_tpu_torch import costs

    shape = (2, 256, 256, 8, 2, 80, True)
    for kern in kernels.GENERAL:
        name = costs.cost_range_name(kern.name, *shape, itemsize)
        assert costs.is_cost_range(name)
        assert costs.range_cost(name) == costs.flash_cost(
            kern.pallas_name, *shape, itemsize)
    b, t, tk, h, kvh, d, _ = shape
    f2, n2 = costs.flash_cost("sofa_flash_gen_fwd", *shape, 2)
    f4, n4 = costs.flash_cost("sofa_flash_gen_fwd", *shape, 4)
    assert f2 == f4
    assert n4 - n2 == 2 * (2 * b * t * h * d + 2 * b * tk * kvh * d)
    old = "sofa_flash_bwd_dq[b=2,t=256,tk=256,h=8,kvh=2,d=80,causal=1]"
    assert costs.range_cost(old) == costs.flash_cost("sofa_flash_bwd_dq",
                                                     *shape)


def test_kernel_perf_counts_the_inputs_type():
    """The general kernels' rows: the four shapes in every mode, bytes at
    the element size, a float32 row against the card's float32 rate."""
    from sofa_tpu_torch.tools import kernel_perf as kp

    card = "NVIDIA H100 80GB HBM3"
    assert kp.card_peaks(card, "float32") == (67e12, 3350e9)
    assert kp.card_peaks(card, "bfloat16") == kp.card_peaks(card)
    assert kp.card_peaks("Some GPU", "float32") is None
    f2, n2 = kp.forward_cost(4, 512, 512, 8, 4, 64, 0)
    f4, n4 = kp.forward_cost(4, 512, 512, 8, 4, 64, 0, 4)
    rows = 4 * 4 * 8 * 512                  # the float32 lse
    assert f2 == f4 and n4 - rows == 2 * (n2 - rows)
    for name, (f, n) in kp.backward_costs(4, 512, 512, 8, 4, 64, 0,
                                          4).items():
        assert kp.backward_costs(4, 512, 512, 8, 4, 64, 0)[name][0] == f
    assert {(r[1], r[2], r[5], r[8]) for r in kp.SWEEP_GENERAL} == {
        (4, 512, 64, "float32"), (1, 8192, 256, "bfloat16"),
        (8, 2048, 16, "bfloat16"), (4, 2048, 128, "float16")}
    assert sorted(r[7] for r in kp.SWEEP_GENERAL) == sorted(kp.MODES * 4)
    for _, b, t, h, kvh, d, _, _, dtype in kp.SWEEP_GENERAL:
        assert tfc.route(getattr(torch, dtype), d) == tuple(kernels.GENERAL)
    row = kp._row("f32 flagship fwd", 4, 512, 8, 4, 64, True, "fwd",
                  ((0.1, 0.1), (0.3, 0.3)), kp.card_peaks(card, "float32"),
                  "float32")
    assert row["dtype"] == "float32"
    assert row["bound_ms"] == pytest.approx(1e3 * kp.forward_cost(
        4, 512, 512, 8, 4, 64, 0, 4)[0] / 67e12)
    md = kp.render_md([row], kp.card_peaks(card), card, card + ", 700 W")
    assert "Float32 rows: **67 TFLOP/s**" in md
