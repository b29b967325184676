"""sofa_tpu_torch's (data, seq) mesh held against the JAX package's.

The tiny float32 transformer runs on four spawned gloo ranks as data 2 x
seq 2, from the JAX package's init (numpy arrays through ``convert``),
against the JAX package's sharded forward and train step on four of the
conftest's virtual CPU devices: logits of the plain ring, the flash ring
and the zig-zag flash ring atol 1e-3 / rtol 1e-3
(``tests/test_workloads.py``), the loss and one AdamW step's parameters
atol 1e-4 / rtol 1e-3.  The JAX side's flash hops run Pallas in interpret
mode (backward: ``_grad_block``), the port's the kernels' plain versions.
Then the collectives microbench on the same mesh, the mesh sizing rules
and ``_bus_factor`` against the JAX package's, and the rank plumbing: a
deadlocked spawn fails within its deadline, a rank that raises fails the
spawn, and ``init_distributed`` refuses what it must.  JAX is imported
only in the reference helpers, so that a spawned rank imports torch
alone.
"""

import dataclasses
import functools
import json
import os
import time

import numpy as np
import pytest
import torch

from sofa_tpu_torch import convert
from sofa_tpu_torch.workloads import collectives
from sofa_tpu_torch.workloads import transformer as ttr
from sofa_tpu_torch.workloads.common import (balanced_factorization,
                                             init_distributed, mesh_sizes,
                                             spawn_ranks)

DATA, SEQ = 2, 2
BATCH, T = 4, 128
LOGIT_ATOL = LOGIT_RTOL = 1e-3
STEP_ATOL, STEP_RTOL = 1e-4, 1e-3
#: (label, flash, zigzag) of the forwards compared
VARIANTS = [("plain_ring", False, False), ("flash_ring", True, False),
            ("zigzag", True, True)]


def _tcfg(flash, zigzag):
    return dataclasses.replace(ttr.TransformerConfig.tiny(seq=T),
                               dtype=torch.float32, flash=flash,
                               zigzag=zigzag)


def _tokens():
    return np.random.default_rng(3).integers(0, 256, (BATCH, T),
                                             dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The JAX package's tiny init, as a flat {path: array} for npz."""
    import jax

    from sofa_tpu.workloads import transformer as jtr

    jcfg = _jcfg(False, False)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp)


def _jcfg(flash, zigzag):
    import jax.numpy as jnp

    from sofa_tpu.workloads import transformer as jtr

    return dataclasses.replace(jtr.TransformerConfig.tiny(seq=T),
                               dtype=jnp.float32, flash=flash, zigzag=zigzag)


def _jax_mesh():
    import jax

    from sofa_tpu.workloads.common import make_mesh

    return make_mesh(("data", "seq", "model"), (DATA, SEQ, 1),
                     devices=jax.devices("cpu")[:DATA * SEQ])


@functools.lru_cache(maxsize=None)
def _jax_logits(flash, zigzag):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sofa_tpu.workloads import transformer as jtr

    cfg, mesh = _jcfg(flash, zigzag), _jax_mesh()
    with jax.default_matmul_precision("highest"):
        params = jtr.shard_params(jax.tree.map(jnp.asarray, _jax_params()),
                                  cfg, mesh)
        tokens = jax.device_put(jnp.asarray(_tokens(), jnp.int32),
                                NamedSharding(mesh, P("data", None)))
        return np.asarray(jtr.forward(params, tokens, cfg, mesh))


@functools.lru_cache(maxsize=None)
def _jax_step():
    """(loss, params after one AdamW step) of the JAX sharded flash ring."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sofa_tpu.workloads import transformer as jtr

    cfg, mesh = _jcfg(True, False), _jax_mesh()
    with jax.default_matmul_precision("highest"):
        params = jtr.shard_params(jax.tree.map(jnp.asarray, _jax_params()),
                                  cfg, mesh)
        tx, step = jtr.make_train_step(cfg, mesh)
        tokens = jax.device_put(jnp.asarray(_tokens(), jnp.int32),
                                NamedSharding(mesh, P("data", None)))
        params, _, loss = step(params, tx.init(params), tokens)
        return float(loss), jax.tree.map(np.asarray, params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, leaf = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


# --- the transformer on four spawned ranks -----------------------------------

def _mesh_rank(rank, store, params_path, out_dir):
    """One rank of data 2 x seq 2: each variant's logits (and the layout
    of its rows and positions), then one training step of the flash ring:
    the summed loss and, on rank 0, the updated params."""
    import torch.distributed as dist

    from sofa_tpu_torch.workloads.common import init_distributed, make_mesh

    torch.set_num_threads(1)        # four ranks share the test's cores
    init_distributed(device="cpu", store_path=store, rank=rank,
                     world_size=DATA * SEQ)
    mesh = make_mesh(("data", "seq", "model"), (DATA, SEQ, 1),
                     device_type="cpu")
    flat = dict(np.load(params_path))
    tokens = torch.from_numpy(_tokens())
    saved = {}
    for label, flash, zigzag in VARIANTS:
        cfg = _tcfg(flash, zigzag)
        params = convert.params_from_numpy(_unflat(flat))
        with torch.no_grad():
            saved[label] = ttr.forward(params, tokens, cfg, mesh=mesh).numpy()
        lay = ttr._layout(cfg, BATCH, T, mesh, tokens.device)
        saved[f"{label}_rows"] = np.arange(BATCH)[lay.rows]
        saved[f"{label}_cols"] = lay.cols.numpy()
    cfg = _tcfg(True, False)
    params = convert.params_from_numpy(_unflat(flat))
    opt, step = ttr.make_train_step(cfg, params, mesh=mesh)
    params, opt, loss = step(params, opt, tokens)
    saved["loss"] = np.asarray(loss.item())
    if rank == 0:
        with torch.no_grad():
            saved.update({f"param.{k}": v
                          for k, v in _flat(params).items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ranks")
    params_path = str(d / "params.npz")
    np.savez(params_path, **_flat(_jax_params()))
    spawn_ranks(DATA * SEQ, _mesh_rank, str(d / "store"), params_path,
                str(d), timeout=300.0)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(DATA * SEQ)]


@pytest.mark.parametrize("label,flash,zigzag", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_logits_match_jax_sharded_forward(mesh_run, label, flash, zigzag):
    got = np.full((BATCH, T, 256), np.nan, np.float32)
    for x in mesh_run:
        got[np.ix_(x[f"{label}_rows"], x[f"{label}_cols"])] = x[label]
    assert np.isfinite(got).all()       # every position came from a rank
    np.testing.assert_allclose(got, _jax_logits(flash, zigzag),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def test_zigzag_ranks_hold_the_balanced_chunks(mesh_run):
    c = T // (2 * SEQ)
    for r, x in enumerate(mesh_run):
        si = r % SEQ
        want = np.r_[si * c:(si + 1) * c,
                     (2 * SEQ - 1 - si) * c:(2 * SEQ - si) * c]
        np.testing.assert_array_equal(x["zigzag_cols"], want)
        np.testing.assert_array_equal(x["flash_ring_cols"],
                                      np.arange(si * T // SEQ,
                                                (si + 1) * T // SEQ))


def test_loss_and_adamw_step_match_jax_sharded_step(mesh_run):
    ref_loss, ref_params = _jax_step()
    losses = [float(x["loss"]) for x in mesh_run]
    assert len(set(losses)) == 1        # the all-reduced loss, everywhere
    np.testing.assert_allclose(losses[0], ref_loss, atol=STEP_ATOL,
                               rtol=STEP_RTOL)
    got = {k[len("param."):]: v for k, v in mesh_run[0].items()
           if k.startswith("param.")}
    ref = _flat(ref_params)
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], atol=STEP_ATOL,
                                   rtol=STEP_RTOL, err_msg=name)


def test_one_rank_mesh_loss_is_the_unsharded_loss():
    """A data 1 x seq 1 mesh computes the unsharded loss to the bit (the
    NCCL world of one on the card relies on it): its shard is the whole
    batch and its share of the mean is times 1.0."""
    cfg = _tcfg(False, False)
    params = convert.params_from_numpy(_unflat(_flat(_jax_params())))
    tokens = torch.from_numpy(_tokens())

    class _OneRankMesh:
        mesh_dim_names = ("data", "seq", "model")

        def size(self, dim):
            return 1

    with torch.no_grad():
        want = ttr.loss_fn(params, tokens, cfg)
        got = ttr.loss_fn(params, tokens, cfg, mesh=_OneRankMesh())
    assert got.item() == want.item()


@pytest.mark.parametrize("field,value", [
    ("n_heads", 6), ("vocab", 250), ("d_ff", 130)])
def test_model_axis_that_does_not_divide_raises_naming_it(field, value):
    """A "model" size must divide the heads, the vocab and d_ff (the
    column and row shards, the vocab slices); the refusal names which."""
    class _TpMesh:
        mesh_dim_names = ("data", "seq", "model")

        def size(self, dim):
            return 4 if dim == 2 else 1

        def get_local_rank(self, axis):
            return 0

        def get_group(self, axis):
            return None

    cfg = dataclasses.replace(_tcfg(False, False), **{field: value})
    if field == "n_heads":
        cfg = dataclasses.replace(cfg, d_model=96)
    with pytest.raises(ValueError, match=f"'model' mesh axis \\(4\\) must "
                                         f"divide {field} \\({value}\\)"):
        ttr._layout(cfg, BATCH, T, _TpMesh(), torch.device("cpu"))


# --- the collectives microbench --------------------------------------------

def _collectives_rank(rank, store, out_dir):
    import torch.distributed as dist

    from sofa_tpu_torch.workloads.common import init_distributed, make_mesh

    torch.set_num_threads(1)        # four ranks share the test's cores
    init_distributed(device="cpu", store_path=store, rank=rank,
                     world_size=DATA * SEQ)
    mesh = make_mesh(("data", "seq"), (DATA, SEQ), device_type="cpu")
    rows = collectives.run(mesh, sizes_mb=[0.125], reps=2)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)
    dist.destroy_process_group()


def test_collectives_run_on_the_data_seq_mesh(tmp_path):
    spawn_ranks(DATA * SEQ, _collectives_rank, str(tmp_path / "store"),
                str(tmp_path), timeout=240.0)
    for r in range(DATA * SEQ):
        rows = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert {x["collective"] for x in rows} == set(collectives.KINDS)
        assert {x["axis"] for x in rows} == {"data", "seq"}
        assert all(x["status"] == "ok" and x["algbw_gbps"] > 0
                   for x in rows), rows
        gather = next(x for x in rows if x["collective"] == "all_gather")
        assert gather["size_mb"] == 2 * 0.125      # the gathered output


def test_bus_factor_matches_jax():
    from sofa_tpu.workloads.collectives import _bus_factor

    for n in range(1, 9):
        for kind in collectives.KINDS:
            assert collectives._bus_factor(kind, n) == _bus_factor(kind, n)


def test_collectives_single_rank_line(capsys, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    collectives.main([])
    assert capsys.readouterr().out == \
        "collectives: single device, nothing to do\n"


def test_mesh_sizes_match_jax_make_mesh():
    import jax

    from sofa_tpu.workloads.common import balanced_factorization as jbf
    from sofa_tpu.workloads.common import make_mesh

    names = ("data", "seq", "model")
    for n in (1, 2, 4, 8):
        devices = jax.devices("cpu")[:n]
        for sizes in (None, (2, -1, 1) if n % 2 == 0 else None,
                      (n, 1, 1)):
            want = tuple(make_mesh(names, sizes, devices=devices)
                         .shape.values())
            assert mesh_sizes(n, names, sizes) == want
    for n, k in ((8, 3), (12, 2), (1, 2), (7, 2), (36, 3)):
        assert balanced_factorization(n, k) == jbf(n, k)
    with pytest.raises(ValueError):
        mesh_sizes(6, names, (4, -1, 1))
    with pytest.raises(ValueError):
        mesh_sizes(4, names, (2, 1, 1))


# --- the rank plumbing -----------------------------------------------------

def _sleeping_rank(rank):
    time.sleep(600)


def _raising_rank(rank):
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    time.sleep(600)


def test_spawn_ranks_kills_a_deadlock_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn_ranks(2, _sleeping_rank, timeout=3.0)
    assert time.monotonic() - t0 < 60


def test_spawn_ranks_fails_when_a_rank_raises():
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails"):
        spawn_ranks(2, _raising_rank, timeout=120.0)
    assert time.monotonic() - t0 < 60


def test_init_distributed_needs_torchrun_or_a_store(monkeypatch):
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        init_distributed(device="cpu")


@pytest.mark.parametrize("share,backend,match", [
    (False, None, "only when asked"),
    (True, None, "NCCL refuses"),
    (True, "nccl", "NCCL refuses"),
])
def test_ranks_share_a_card_only_when_asked_and_never_under_nccl(
        monkeypatch, share, backend, match):
    """Two ranks of a host with one card: refused unless asked, and under
    NCCL even then; both before any process group or device is set."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: pytest.fail(
        "set_device before the refusal"))
    for name, value in (("RANK", "1"), ("WORLD_SIZE", "2"),
                        ("LOCAL_RANK", "1"), ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(name, value)
    with pytest.raises(RuntimeError, match=match):
        init_distributed(backend, share_device=share)
