"""sofa_tpu_torch's GPipe pipeline held against the JAX package's.

One JAX init of the tiny float32 pipeline model (4 stages of one layer)
crosses as numpy arrays.  Eight spawned gloo ranks as (data 2, stage 4)
run ``pipeline_loss`` over P2P rotations of the stage group; the JAX
package runs ``pipeline_loss`` on its (2, 4) mesh of virtual CPU devices.
The loss within 1e-4 and every gradient within 1e-5 max-abs of the JAX
package's (``tests/test_workloads.py:668-704``), and of the unpipelined
``_reference_forward``; remat's gradients within 1e-6 of no remat's; the
lockstep schedule (every stage's tick in one process, the carries rolled
through a list) bit-equal to the spawned ranks, stage by stage.  Then one
training step on each rank.  JAX is imported only in the reference
helpers.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from sofa_tpu_torch import convert
from sofa_tpu_torch.workloads import pipeline as tpp
from sofa_tpu_torch.workloads.transformer import param_leaves

BATCH, T = 8, 32
MESH = (2, 4)                   # (data, stage)
LOSS_TOL, GRAD_TOL, REMAT_TOL = 1e-4, 1e-5, 1e-6
REPLICATED = ("embed", "final_norm", "lm_head")


def _tcfg(remat=False):
    return dataclasses.replace(tpp.PipelineConfig.tiny(), dtype=torch.float32,
                               remat=remat)


def _tokens():
    return np.random.default_rng(13).integers(0, 256, (BATCH, T),
                                              dtype=np.int64)


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


def _grads(params, prefix=""):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_grads(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.grad.numpy().copy()
    return out


# --- the JAX references ------------------------------------------------------

def _jcfg():
    import jax.numpy as jnp

    from sofa_tpu.workloads import pipeline as jpp

    return dataclasses.replace(jpp.PipelineConfig.tiny(), dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _jax_params():
    import jax

    from sofa_tpu.workloads import pipeline as jpp

    cfg = _jcfg()
    return _flat(jax.tree.map(np.asarray, jpp.init_params(
        cfg, MESH[1] * cfg.layers_per_stage, jax.random.PRNGKey(0))))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    """(pipelined loss, its gradients) on the JAX (2, 4) mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sofa_tpu.workloads import pipeline as jpp
    from sofa_tpu.workloads.common import make_mesh

    cfg = _jcfg()
    mesh = make_mesh(("data", "stage"), MESH,
                     devices=jax.devices("cpu")[:MESH[0] * MESH[1]])
    with jax.default_matmul_precision("highest"):
        params = jax.tree.map(
            lambda x, s: jax.device_put(jnp.asarray(x),
                                        NamedSharding(mesh, s)),
            _unflat(_jax_params()), jpp.param_specs())
        tokens = jax.device_put(jnp.asarray(_tokens(), jnp.int32),
                                NamedSharding(mesh, P("data", None)))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jpp.pipeline_loss(p, tokens, cfg, mesh)))(params)
        return float(loss), _flat(jax.tree.map(np.asarray, grads))


def _reference_loss_and_grads():
    """The unpipelined twin's mean loss and gradients, in the port."""
    params = convert.params_from_numpy(_unflat(_jax_params()))
    for p in param_leaves(params):
        p.requires_grad_(True)
    tokens = torch.from_numpy(_tokens())
    logits = tpp._reference_forward(params, tokens, _tcfg())[:, :-1]
    gold = logits.gather(-1, tokens[:, 1:, None])[..., 0]
    loss = (torch.logsumexp(logits, -1) - gold).mean()
    loss.backward()
    return loss.item(), _grads(params)


# --- the ranks ---------------------------------------------------------------

def _stage_params(flat, stage):
    return tpp.stage_params(convert.params_from_numpy(_unflat(flat)), stage,
                            MESH[1])


def _pp_rank(rank, store, params_path, out_dir):
    """This rank's loss share and its gradients before any reduction, with
    and without remat; then one training step."""
    import torch.distributed as dist

    from sofa_tpu_torch.workloads.common import (init_distributed,
                                                 make_mesh, mesh_axis)

    torch.set_num_threads(1)
    init_distributed(device="cpu", store_path=store, rank=rank,
                     world_size=MESH[0] * MESH[1])
    mesh = make_mesh(("data", "stage"), MESH, device_type="cpu")
    flat = dict(np.load(params_path))
    tokens = torch.from_numpy(_tokens())
    stage = mesh_axis(mesh, "stage").index
    saved = {"stage": np.asarray(stage),
             "data": np.asarray(mesh_axis(mesh, "data").index)}
    for remat in (False, True):
        params = _stage_params(flat, stage)
        for p in param_leaves(params):
            p.requires_grad_(True)
        loss = tpp.pipeline_loss(params, tokens, _tcfg(remat), mesh)
        loss.backward()
        saved[f"loss.{remat}"] = np.asarray(loss.item())
        saved.update({f"grad.{remat}.{k}": v
                      for k, v in _grads(params).items()})
    params = _stage_params(flat, stage)
    opt, step = tpp.make_train_step(_tcfg(), params, mesh)
    losses = [step(params, opt, tokens)[2].item() for _ in range(3)]
    saved["steps"] = np.asarray(losses)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def pp_run(tmp_path_factory):
    from sofa_tpu_torch.workloads.common import spawn_ranks

    d = tmp_path_factory.mktemp("pp_ranks")
    params_path = str(d / "params.npz")
    np.savez(params_path, **_jax_params())
    n = MESH[0] * MESH[1]
    spawn_ranks(n, _pp_rank, str(d / "store"), params_path, str(d),
                timeout=300.0)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]


def _reduced(pp_run, remat=False):
    """The summed loss and the gradients as the step reduces them: a
    stage's layers over "data", the replicated leaves over every rank;
    the layers assembled over the stages."""
    loss = sum(float(x[f"loss.{remat}"]) for x in pp_run)
    grads = {}
    for path in _flat(_unflat(_jax_params())):
        if path in REPLICATED:
            grads[path] = sum(x[f"grad.{remat}.{path}"] for x in pp_run)
            continue
        blocks = [sum(x[f"grad.{remat}.{path}"] for x in pp_run
                      if int(x["stage"]) == s) for s in range(MESH[1])]
        grads[path] = np.concatenate(blocks, 0)
    return loss, grads


def test_loss_and_gradients_match_jax_pipeline(pp_run):
    loss, grads = _reduced(pp_run)
    ref_loss, ref_grads = _jax_loss_and_grads()
    assert abs(loss - ref_loss) < LOSS_TOL
    assert set(grads) == set(ref_grads)
    for path, ref in ref_grads.items():
        assert np.abs(grads[path] - ref).max() < GRAD_TOL, path


def test_pipeline_matches_the_unpipelined_reference(pp_run):
    loss, grads = _reduced(pp_run)
    ref_loss, ref_grads = _reference_loss_and_grads()
    assert abs(loss - ref_loss) < LOSS_TOL
    for path, ref in ref_grads.items():
        assert np.abs(grads[path] - ref).max() < GRAD_TOL, path


def test_remat_changes_memory_not_math(pp_run):
    loss, grads = _reduced(pp_run)
    loss_r, grads_r = _reduced(pp_run, remat=True)
    assert loss_r == loss
    for path, g in grads.items():
        assert np.abs(grads_r[path] - g).max() < REMAT_TOL, path


@pytest.mark.parametrize("remat", [False, True])
def test_lockstep_ticks_are_bit_equal_to_the_ranks(pp_run, remat):
    """Each data shard's pipeline with every stage in this process: each
    stage's loss share and gradients equal to its rank's to the bit."""
    flat = _jax_params()
    tokens = torch.from_numpy(_tokens())
    rows = BATCH // MESH[0]
    for d in range(MESH[0]):
        stages = [_stage_params(flat, s) for s in range(MESH[1])]
        for params in stages:
            for p in param_leaves(params):
                p.requires_grad_(True)
        losses = [x / MESH[0] for x in tpp.lockstep_loss(
            stages, tokens[d * rows:(d + 1) * rows], _tcfg(remat))]
        torch.stack(losses).sum().backward()
        for s, (loss, params) in enumerate(zip(losses, stages)):
            rank = next(x for x in pp_run if int(x["data"]) == d
                        and int(x["stage"]) == s)
            assert loss.item() == float(rank[f"loss.{remat}"])
            for path, g in _grads(params).items():
                np.testing.assert_array_equal(
                    g, rank[f"grad.{remat}.{path}"],
                    err_msg=f"data {d} stage {s} {path}")


def test_training_steps_descend_alike_on_every_rank(pp_run):
    steps = [tuple(x["steps"]) for x in pp_run]
    assert len(set(steps)) == 1
    assert np.isfinite(steps[0]).all() and steps[0][-1] < steps[0][0]
