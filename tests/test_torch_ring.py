"""sofa_tpu_torch's sequence-parallel attention held against the JAX
package's on four ranks.

Ring and zig-zag flash attention (``ring_flash.py``) and the plain ring
(``ring_attention.py``) take the same inputs, made with numpy from a seed,
as the JAX package's ``ring_flash_attention``,
``zigzag_ring_flash_attention`` and ``ring_attention`` on a mesh of four
of the conftest's virtual CPU devices (seq = 4): forward atol 1e-5 / rtol
1e-4, gradients atol 1e-4 / rtol 1e-3 (``tests/test_workloads.py``).  The
JAX ring's forward hops run Pallas in interpret mode and its backward hops
``_grad_block``; the port's hops run the kernels' plain versions (CPU
tensors).  The cases run twice: through the lockstep schedule in this
process (every rank's hops, then a roll of the shards), and on four
spawned gloo ranks (one spawn for every case, under a deadline), which
must give the lockstep schedule's numbers.  This module imports JAX only in
its reference helpers, so that a spawned rank imports torch alone.
"""

import functools
import os

import numpy as np
import pytest
import torch

from sofa_tpu_torch import kernels
from sofa_tpu_torch.workloads import ring_flash as rf
from sofa_tpu_torch.workloads.common import spawn_ranks

N = 4                                  # ranks = the JAX mesh's seq axis
B, T, H, D = 2, 128, 4, 16
FWD_ATOL, FWD_RTOL = 1e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
CASES = [(zz, kvh) for zz in (False, True) for kvh in (H, 2)]
CASE_IDS = [f"{'zigzag' if zz else 'ring'}-{'gqa' if kvh < H else 'dense'}"
            for zz, kvh in CASES]


def _inputs(kvh, seed=0):
    """Global q, k, v and the output cotangent g, float32, [B, T, *, D]."""
    rng = np.random.default_rng(seed + kvh)
    q, g = (rng.standard_normal((B, T, H, D), np.float32) for _ in "qg")
    k, v = (rng.standard_normal((B, T, kvh, D), np.float32) for _ in "kv")
    return q, k, v, g


def _order(zigzag):
    """The global positions in shard order (zig-zag or plain)."""
    return rf.zigzag_indices(T, N)[0] if zigzag else np.arange(T)


def _shards(x, zigzag):
    """Rank r's rows of the global [B, T, ...] array, as torch tensors."""
    x = torch.from_numpy(np.ascontiguousarray(x[:, _order(zigzag)]))
    return [s.contiguous() for s in x.chunk(N, dim=1)]


@functools.lru_cache(maxsize=None)
def _jax_ring(zigzag, kvh):
    """The JAX package's out and (dq, dk, dv), in shard order."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sofa_tpu.workloads import ring_flash
    from sofa_tpu.workloads.common import make_mesh

    mesh = make_mesh(("data", "seq", "model"), (1, N, 1),
                     devices=jax.devices("cpu")[:N])
    spec = NamedSharding(mesh, P("data", "seq", "model", None))
    fn = (ring_flash.zigzag_ring_flash_attention if zigzag
          else ring_flash.ring_flash_attention)
    order = _order(zigzag)
    with jax.default_matmul_precision("highest"):
        q, k, v, g = (jax.device_put(jnp.asarray(x[:, order]), spec)
                      for x in _inputs(kvh))
        out, vjp = jax.vjp(lambda *a: fn(*a, mesh), q, k, v)
        grads = vjp(g)
    return np.asarray(out), tuple(np.asarray(x) for x in grads)


@functools.lru_cache(maxsize=None)
def _jax_plain_ring():
    """The JAX package's plain ring_attention out, dense, in shard order."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sofa_tpu.workloads.common import make_mesh
    from sofa_tpu.workloads.ring_attention import ring_attention

    mesh = make_mesh(("data", "seq", "model"), (1, N, 1),
                     devices=jax.devices("cpu")[:N])
    spec = NamedSharding(mesh, P("data", "seq", "model", None))
    with jax.default_matmul_precision("highest"):
        q, k, v, _ = (jax.device_put(jnp.asarray(x), spec)
                      for x in _inputs(H))
        return np.asarray(ring_attention(q, k, v, mesh))


@functools.lru_cache(maxsize=None)
def _lockstep(zigzag, kvh):
    q, k, v, g = (_shards(x, zigzag) for x in _inputs(kvh))
    outs, lses = rf.lockstep_forward(q, k, v, zigzag)
    grads = rf.lockstep_backward(q, k, v, outs, lses, g, zigzag)
    cat = [torch.cat(x, dim=1).numpy() for x in (outs, *grads)]
    return cat[0], tuple(cat[1:]), torch.cat(lses, dim=-1).numpy()


@pytest.mark.parametrize("zigzag,kvh", CASES, ids=CASE_IDS)
def test_lockstep_matches_jax(zigzag, kvh):
    out, grads, _ = _lockstep(zigzag, kvh)
    ref_out, ref_grads = _jax_ring(zigzag, kvh)
    np.testing.assert_allclose(out, ref_out, atol=FWD_ATOL, rtol=FWD_RTOL)
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(a, r, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("zigzag,kvh", CASES, ids=CASE_IDS)
def test_lockstep_lse_matches_one_device(zigzag, kvh):
    """The merged lse equals the one-device forward's over the whole
    sequence, and no hop (fully masked ones included) leaves a NaN."""
    from sofa_tpu_torch.workloads.flash_cuda import _flash_forward

    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(kvh))
    _, ref_lse = _flash_forward(q, k, v, 0)
    _, _, lse = _lockstep(zigzag, kvh)
    assert np.isfinite(lse).all()
    np.testing.assert_allclose(lse, ref_lse.numpy()[..., _order(zigzag)],
                               atol=FWD_ATOL, rtol=FWD_RTOL)


@pytest.mark.parametrize("zigzag", [False, True], ids=["ring", "zigzag"])
def test_lockstep_launches_a_hop_per_rank(zigzag):
    """Each hop body runs the kernels' wrappers once per pair: n*n forward
    calls for the ring, 3*n*n for zig-zag (on the CPU the wrappers take the
    plain versions and count nothing; the calls are counted here)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = rf._flash_forward, rf._flash_backward

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    rng = np.random.default_rng(5)
    q, k, v, g = (list(torch.from_numpy(rng.standard_normal(
        (1, 8 * N, 2, 8), np.float32)).chunk(N, dim=1)) for _ in range(4))
    rf._flash_forward, rf._flash_backward = (count("fwd", fwd),
                                             count("bwd", bwd))
    try:
        kernels.reset_counts()
        outs, lses = rf.lockstep_forward(q, k, v, zigzag)
        rf.lockstep_backward(q, k, v, outs, lses, g, zigzag)
    finally:
        rf._flash_forward, rf._flash_backward = fwd, bwd
    per = 3 if zigzag else 1
    assert calls == {"fwd": per * N * N, "bwd": per * N * N}
    assert not any(kernels.counts().values())


def test_zigzag_indices_match_jax():
    from sofa_tpu.workloads.ring_flash import zigzag_indices

    for t, s in ((128, 4), (16, 2), (8, 1)):
        for a, b in zip(rf.zigzag_indices(t, s), zigzag_indices(t, s)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        rf.zigzag_indices(10, 4)


def test_hop_shifts_match_jax():
    from sofa_tpu.workloads import ring_flash as jrf

    for n in (1, 2, 4):
        for r in range(n):
            for i in range(n):
                assert rf._hop_shift(i, r, n, 32) == int(
                    jrf._hop_shift(i, r, n, 32))
                assert rf._zigzag_hop_shifts(i, r, n, 16) == tuple(
                    int(x) for x in jrf._zigzag_hop_shifts(i, r, n, 16))


def test_lse_merge_of_a_masked_hop_keeps_the_running_result():
    """A fully masked hop (lse -1e29, out 0) folds in with weight 0, and
    the initial -1e30 takes a masked hop without a NaN."""
    o = torch.randn(1, 3, 2, 4)
    lse = torch.randn(1, 2, 3)
    masked_o, masked_lse = torch.zeros(1, 3, 2, 4), torch.full((1, 2, 3),
                                                               -1e29)
    got_o, got_lse = rf._lse_merge(o, lse, masked_o, masked_lse)
    assert torch.equal(got_o, o) and torch.equal(got_lse, lse)
    init_o, init_lse = torch.zeros(1, 3, 2, 4), torch.full((1, 2, 3), -1e30)
    got_o, got_lse = rf._lse_merge(init_o, init_lse, masked_o, masked_lse)
    assert torch.isfinite(got_o).all() and (got_o == 0).all()
    assert (got_lse <= -1e29).all() and torch.isfinite(got_lse).all()


def test_one_rank_ring_is_one_device_attention():
    """With n = 1 the rotation is the identity (no send to self)."""
    from sofa_tpu_torch.workloads.common import Ring
    from sofa_tpu_torch.workloads.flash_cuda import flash_causal_attention

    q, k, v, g = (torch.from_numpy(x).requires_grad_(True)
                  for x in _inputs(2))
    out = rf.ring_flash_attention_local(q, k, v, Ring(0, 1))
    ref = flash_causal_attention(q, k, v)
    torch.testing.assert_close(out, ref, atol=FWD_ATOL, rtol=FWD_RTOL)
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(ref, (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)


# --- four spawned gloo ranks ---------------------------------------------------

def _ring_rank(rank, store, out_dir):
    """One rank: every ring case through the mesh API (forward, then
    autograd's backward), and the plain ring; saves its shards."""
    import torch.distributed as dist

    from sofa_tpu_torch.workloads.common import init_distributed, make_mesh
    from sofa_tpu_torch.workloads.ring_attention import ring_attention

    torch.set_num_threads(1)        # four ranks share the test's cores
    init_distributed(device="cpu", store_path=store, rank=rank,
                     world_size=N)
    mesh = make_mesh(("seq",), (N,), device_type="cpu")
    saved = {}
    for zigzag, kvh in CASES:
        q, k, v, g = (_shards(x, zigzag)[rank] for x in _inputs(kvh))
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        fn = (rf.zigzag_ring_flash_attention if zigzag
              else rf.ring_flash_attention)
        out = fn(q, k, v, mesh)
        out.backward(g)
        key = f"{int(zigzag)}_{kvh}"
        for name, x in (("out", out), ("dq", q.grad), ("dk", k.grad),
                        ("dv", v.grad)):
            saved[f"{key}_{name}"] = x.detach().numpy()
    q, k, v, _ = (_shards(x, False)[rank] for x in _inputs(H))
    saved["plain"] = ring_attention(q, k, v, mesh).numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring_ranks")
    spawn_ranks(N, _ring_rank, str(d / "store"), str(d), timeout=240.0)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(N)]
    return {key: np.concatenate([x[key] for x in ranks], axis=1)
            for key in ranks[0]}


@pytest.mark.parametrize("zigzag,kvh", CASES, ids=CASE_IDS)
def test_spawned_ranks_match_jax_and_lockstep(spawned, zigzag, kvh):
    key = f"{int(zigzag)}_{kvh}"
    out = spawned[f"{key}_out"]
    grads = [spawned[f"{key}_{n}"] for n in ("dq", "dk", "dv")]
    ref_out, ref_grads = _jax_ring(zigzag, kvh)
    np.testing.assert_allclose(out, ref_out, atol=FWD_ATOL, rtol=FWD_RTOL)
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(a, r, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
    # only the rotation differs between the two schedules
    lock_out, lock_grads, _ = _lockstep(zigzag, kvh)
    np.testing.assert_array_equal(out, lock_out)
    for a, b in zip(grads, lock_grads):
        np.testing.assert_array_equal(a, b)


def test_spawned_plain_ring_matches_jax(spawned):
    np.testing.assert_allclose(spawned["plain"], _jax_plain_ring(),
                               atol=FWD_ATOL, rtol=FWD_RTOL)
