"""sofa_tpu_torch's Switch MoE held against the JAX package's.

One JAX init of the tiny float32 MoE crosses as numpy arrays
(``convert``; the router stays float32 in every dtype).  In process: the
dense path's logits and aux against the JAX package's (atol 1e-5, rtol
1e-4, ``tests/test_workloads.py:610-637``), and ``_dispatch_tensors``
against the JAX one on the same logits: the same tokens kept and dropped,
the same slots, gates and aux.  On eight spawned gloo ranks as (data 2,
expert 4), against the JAX package on its (2, 4) mesh of virtual CPU
devices: the expert-parallel logits and aux with no token dropped (equal
to the dense path's too), then with the default capacity (drops per
shard), and one AdamW step (loss and every leaf, atol 1e-5 / rtol 1e-4).
JAX is imported only in the reference helpers.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from sofa_tpu_torch import convert
from sofa_tpu_torch.workloads import moe as tmoe
from sofa_tpu_torch.workloads.common import spawn_ranks

BATCH, T = 8, 32
MESH = (2, 4)
ATOL, RTOL = 1e-5, 1e-4
#: capacity factors of the expert-parallel forwards: no drops, the default
FACTORS = (4.0, 1.25)


def _tcfg(capacity_factor=1.25):
    return dataclasses.replace(tmoe.MoEConfig.tiny(n_experts=4),
                               dtype=torch.float32,
                               capacity_factor=capacity_factor)


def _tokens():
    return np.random.default_rng(11).integers(0, 256, (BATCH, T),
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


# --- the JAX references ------------------------------------------------------

def _jcfg(capacity_factor=1.25):
    import jax.numpy as jnp

    from sofa_tpu.workloads import moe as jmoe

    return dataclasses.replace(jmoe.MoEConfig.tiny(n_experts=4),
                               dtype=jnp.float32,
                               capacity_factor=capacity_factor)


@functools.lru_cache(maxsize=None)
def _jax_params():
    import jax

    from sofa_tpu.workloads import moe as jmoe

    return _flat(jax.tree.map(np.asarray, jmoe.init_params(
        _jcfg(), jax.random.PRNGKey(0))))


def _jax_sharded(mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sofa_tpu.workloads import moe as jmoe

    params = jax.tree.map(
        lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
        _unflat(_jax_params()), jmoe.param_specs(_jcfg()))
    tokens = jax.device_put(jnp.asarray(_tokens(), jnp.int32),
                            NamedSharding(mesh, P(("data", "expert"), None)))
    return params, tokens


def _jax_mesh():
    import jax

    from sofa_tpu.workloads.common import make_mesh

    return make_mesh(("data", "expert"), MESH,
                     devices=jax.devices("cpu")[:MESH[0] * MESH[1]])


@functools.lru_cache(maxsize=None)
def _jax_forward(capacity_factor, sharded):
    import jax
    import jax.numpy as jnp

    from sofa_tpu.workloads import moe as jmoe

    cfg = _jcfg(capacity_factor)
    with jax.default_matmul_precision("highest"):
        if not sharded:
            logits, aux = jax.jit(lambda p, t: jmoe.forward(p, t, cfg))(
                jax.tree.map(jnp.asarray, _unflat(_jax_params())),
                jnp.asarray(_tokens(), jnp.int32))
        else:
            mesh = _jax_mesh()
            params, tokens = _jax_sharded(mesh)
            logits, aux = jax.jit(lambda p, t: jmoe.forward(
                p, t, cfg, mesh))(params, tokens)
        return np.asarray(logits), float(aux)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """(loss, params after one AdamW step) of the JAX expert-parallel
    step (``moe.build``'s, on the carried init)."""
    import jax
    import optax

    from sofa_tpu.workloads import moe as jmoe

    cfg, mesh = _jcfg(), _jax_mesh()
    with jax.default_matmul_precision("highest"):
        params, tokens = _jax_sharded(mesh)
        tx = optax.adamw(3e-4)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, t: jmoe.loss_fn(p, t, cfg, mesh)))(params, tokens)
        updates, _ = tx.update(grads, tx.init(params), params)
        params = optax.apply_updates(params, updates)
        return float(loss), _flat(jax.tree.map(np.asarray, params))


# --- in process --------------------------------------------------------------

def test_dense_logits_and_aux_match_jax():
    logits, aux = tmoe.forward(convert.params_from_numpy(
        _unflat(_jax_params())), torch.from_numpy(_tokens()), _tcfg())
    want_logits, want_aux = _jax_forward(1.25, False)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(aux.item(), want_aux, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n,experts,capacity", [(6, 2, 2), (64, 4, 10),
                                                (64, 4, 40), (33, 8, 3)])
def test_dispatch_drops_tokens_as_jax_does(n, experts, capacity):
    """The same routing on the same logits: every token kept or dropped
    alike, each kept one in the same slot, the same gates and aux."""
    import jax.numpy as jnp

    from sofa_tpu.workloads.moe import _dispatch_tensors

    logits = np.random.default_rng(n).normal(size=(n, experts)).astype(
        np.float32)
    if n == 6:          # the JAX test's case: all prefer expert 0
        logits = np.array([[5.0, 0.0]] * 6, np.float32)
    got = tmoe._dispatch_tensors(torch.from_numpy(logits), experts,
                                 capacity)
    want = _dispatch_tensors(jnp.asarray(logits), experts, capacity)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7,
                                   rtol=1e-6)
    kept = got[0].sum().item()
    assert kept <= experts * capacity
    if n == 6:
        assert kept == 2.0


def test_router_stays_float32_when_carried_over_in_bf16():
    params = convert.params_from_numpy(_unflat(_jax_params()),
                                       dtype=torch.bfloat16)
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["moe_norm"].dtype == torch.float32
    assert params["layers"]["w_up"].dtype == torch.bfloat16


def test_expert_axis_must_divide_the_experts():
    class _Mesh:
        mesh_dim_names = ("data", "expert")

        def size(self, dim):
            return 3 if dim == 1 else 1

        def get_local_rank(self, axis):
            return 0

        def get_group(self, axis):
            return None

    with pytest.raises(ValueError, match="must divide over the expert"):
        tmoe._layout(_tcfg(), 6, _Mesh())


# --- the expert-parallel ranks -----------------------------------------------

def _moe_rank(rank, store, params_path, out_dir):
    import torch.distributed as dist

    from sofa_tpu_torch.workloads.common import init_distributed, make_mesh

    torch.set_num_threads(1)
    init_distributed(device="cpu", store_path=store, rank=rank,
                     world_size=MESH[0] * MESH[1])
    mesh = make_mesh(("data", "expert"), MESH, device_type="cpu")
    flat = dict(np.load(params_path))
    tokens = torch.from_numpy(_tokens())

    def params():
        from sofa_tpu_torch.workloads.common import mesh_axis

        ax = mesh_axis(mesh, "expert")
        return convert.shard_tree(
            convert.params_from_numpy(_unflat(flat)),
            tmoe.param_specs(_tcfg()), {"expert": (ax.index, ax.size)})

    lay = tmoe._layout(_tcfg(), BATCH, mesh)
    saved = {"rows": np.arange(BATCH)[lay.rows],
             "expert": np.asarray(lay.expert.index)}
    for cf in FACTORS:
        with torch.no_grad():
            logits, aux = tmoe.forward(params(), tokens, _tcfg(cf), mesh)
        saved[f"logits{cf}"] = logits.numpy()
        saved[f"aux{cf}"] = np.asarray(aux.item())
    p = params()
    opt, step = tmoe.make_train_step(_tcfg(), p, mesh=mesh)
    p, opt, loss = step(p, opt, tokens)
    saved["loss"] = np.asarray(loss.item())
    with torch.no_grad():
        saved.update({f"param.{k}": v for k, v in _flat(p).items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def moe_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ranks")
    params_path = str(d / "params.npz")
    np.savez(params_path, **_jax_params())
    n = MESH[0] * MESH[1]
    spawn_ranks(n, _moe_rank, str(d / "store"), params_path, str(d),
                timeout=300.0)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]


@pytest.mark.parametrize("capacity_factor", FACTORS)
def test_expert_parallel_logits_and_aux_match_jax(moe_run, capacity_factor):
    got = np.full((BATCH, T, 256), np.nan, np.float32)
    for x in moe_run:
        got[x["rows"]] = x[f"logits{capacity_factor}"]
    assert np.isfinite(got).all()
    want_logits, want_aux = _jax_forward(capacity_factor, True)
    np.testing.assert_allclose(got, want_logits, atol=ATOL, rtol=RTOL)
    auxes = {float(x[f"aux{capacity_factor}"]) for x in moe_run}
    assert len(auxes) == 1              # averaged over every rank
    np.testing.assert_allclose(auxes.pop(), want_aux, atol=ATOL, rtol=RTOL)
    if capacity_factor == 4.0:          # no drops: the dense path's logits
        np.testing.assert_allclose(got, _jax_forward(4.0, False)[0],
                                   atol=ATOL, rtol=RTOL)


def test_one_adamw_step_matches_jax(moe_run):
    ref_loss, ref_params = _jax_step()
    losses = {float(x["loss"]) for x in moe_run}
    assert len(losses) == 1
    np.testing.assert_allclose(losses.pop(), ref_loss, atol=ATOL, rtol=RTOL)
    specs = tmoe.param_specs(_tcfg())
    for path, ref in ref_params.items():
        spec = specs
        for k in path.split("."):
            spec = spec[k]
        if "expert" in spec:        # the experts from each expert rank
            dim = spec.index("expert")
            blocks = {int(x["expert"]): x[f"param.{path}"] for x in moe_run}
            got = np.concatenate([blocks[i] for i in range(MESH[1])], dim)
        else:
            got = moe_run[0][f"param.{path}"]
            for x in moe_run[1:]:   # replicated: the same on every rank
                np.testing.assert_array_equal(x[f"param.{path}"], got)
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL,
                                   err_msg=path)
