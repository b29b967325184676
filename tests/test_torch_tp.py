"""sofa_tpu_torch's tensor parallelism, FSDP and sharded generate held
against the JAX package's.

The tiny float32 transformer runs on spawned gloo ranks, from the JAX
package's init (numpy arrays through ``convert``, each rank cut to its
shard by ``shard_params``), against the JAX package's sharded forward,
train step and ``generate`` on the conftest's virtual CPU devices, mesh
for mesh:

* two ranks: (data, seq, model) = (1, 1, 2), and ("data", "model") =
  (1, 2) for ``generate``;
* eight ranks: (2, 2, 2) with and without FSDP, (2, 1, 4), where the two
  KV heads do not divide over the four model ranks, and ("data", "model")
  = (4, 2) for ``generate``.

Logits atol = rtol = 1e-3 (``tests/test_workloads.py:288-312``, the
flash path's local heads too), the loss and one AdamW step's params
(assembled from every rank's shards) atol 1e-4 / rtol 1e-3, greedy
tokens exactly; the replicated leaves' gradients equal on every model
rank.  Then the layout's refusals.  JAX is imported only in the
reference helpers, so that a spawned rank imports torch alone.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from sofa_tpu_torch import convert
from sofa_tpu_torch.workloads import inference as tinf
from sofa_tpu_torch.workloads import transformer as ttr
from sofa_tpu_torch.workloads.common import spawn_ranks

BATCH, T, PROMPT, NEW = 4, 32, 8, 6
LOGIT_ATOL = LOGIT_RTOL = 1e-3
STEP_ATOL, STEP_RTOL = 1e-4, 1e-3
#: (label, (data, seq, model), fsdp) of the training meshes, by world size
TRAIN = {2: [("tp112", (1, 1, 2), False)],
         8: [("tp222", (2, 2, 2), False), ("fsdp222", (2, 2, 2), True),
             ("kv214", (2, 1, 4), False)]}
#: (label, (data, model)) of the serving meshes, by world size
SERVE = {2: [("gen12", (1, 2))], 8: [("gen42", (4, 2))]}
REPLICATED = ("attn_norm", "mlp_norm", "final_norm")


def _tcfg(flash=None):
    return dataclasses.replace(ttr.TransformerConfig.tiny(seq=T),
                               dtype=torch.float32, flash=flash)


def _tokens():
    return np.random.default_rng(5).integers(0, 256, (BATCH, T),
                                             dtype=np.int64)


def _prompt():
    return np.random.default_rng(6).integers(0, 256, (BATCH, PROMPT),
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


def _spec(path, fsdp):
    node = ttr.param_specs(_tcfg(), fsdp)
    for k in path.split("."):
        node = node[k]
    return node


def _assemble(blocks, path, fsdp):
    """One global leaf from every rank's block of it: each block goes where
    its rank's coordinates put it (replicas overwrite with their copies,
    which must agree)."""
    spec = _spec(path, fsdp)
    shape = [b * (x["coords"][a][1] if a else 1) for x in blocks[:1]
             for b, a in zip(x["block"].shape, spec)]
    out = np.full(shape, np.nan, np.float32)
    for x in blocks:
        index = []
        for dim, axis in enumerate(spec):
            n = x["block"].shape[dim]
            i = x["coords"][axis][0] if axis else 0
            index.append(slice(i * n, (i + 1) * n))
        out[tuple(index)] = x["block"]
    return out


# --- the JAX references ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params():
    import jax

    from sofa_tpu.workloads import transformer as jtr

    jp = jtr.init_params(_jcfg(), jax.random.PRNGKey(0))
    return _flat(jax.tree.map(np.asarray, jp))


def _jcfg():
    import jax.numpy as jnp

    from sofa_tpu.workloads import transformer as jtr

    return dataclasses.replace(jtr.TransformerConfig.tiny(seq=T),
                               dtype=jnp.float32)


def _jax_mesh(names, sizes):
    import jax

    from sofa_tpu.workloads.common import make_mesh

    return make_mesh(names, sizes,
                     devices=jax.devices("cpu")[:int(np.prod(sizes))])


@functools.lru_cache(maxsize=None)
def _jax_logits(sizes):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sofa_tpu.workloads import transformer as jtr

    cfg, mesh = _jcfg(), _jax_mesh(("data", "seq", "model"), sizes)
    with jax.default_matmul_precision("highest"):
        params = jtr.shard_params(
            jax.tree.map(jnp.asarray, _unflat(_jax_params())), cfg, mesh)
        tokens = jax.device_put(jnp.asarray(_tokens(), jnp.int32),
                                NamedSharding(mesh, P("data", None)))
        return np.asarray(jax.jit(lambda p, t: jtr.forward(
            p, t, cfg, mesh))(params, tokens))


@functools.lru_cache(maxsize=None)
def _jax_step(sizes, fsdp):
    """(loss, params after one AdamW step) of the JAX sharded step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sofa_tpu.workloads import transformer as jtr

    cfg, mesh = _jcfg(), _jax_mesh(("data", "seq", "model"), sizes)
    with jax.default_matmul_precision("highest"):
        params = jtr.shard_params(
            jax.tree.map(jnp.asarray, _unflat(_jax_params())), cfg, mesh,
            fsdp)
        tx, step = jtr.make_train_step(cfg, mesh)
        tokens = jax.device_put(jnp.asarray(_tokens(), jnp.int32),
                                NamedSharding(mesh, P("data", None)))
        params, _, loss = step(params, tx.init(params), tokens)
        return float(loss), _flat(jax.tree.map(np.asarray, params))


@functools.lru_cache(maxsize=None)
def _jax_generate(sizes):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sofa_tpu.workloads import inference as jinf
    from sofa_tpu.workloads import transformer as jtr

    cfg, mesh = _jcfg(), _jax_mesh(("data", "model"), sizes)
    with jax.default_matmul_precision("highest"):
        params = jtr.shard_params(
            jax.tree.map(jnp.asarray, _unflat(_jax_params())), cfg, mesh)
        prompt = jax.device_put(jnp.asarray(_prompt(), jnp.int32),
                                NamedSharding(mesh, P("data", None)))
        return np.asarray(jax.jit(lambda p, x: jinf.generate(
            p, x, NEW, cfg, mesh))(params, prompt))


# --- the ranks ---------------------------------------------------------------

def _tp_rank(rank, world, store, params_path, out_dir):
    """Every training and serving mesh of this world size, in turn: the
    local logits (plain and fused attention) with where they sit, the
    replicated leaves' gradients, one step's loss and shards; the greedy
    tokens of ``generate``."""
    import torch.distributed as dist

    from sofa_tpu_torch.workloads.common import (init_distributed,
                                                 make_mesh)

    torch.set_num_threads(1)        # the ranks share the test's cores
    init_distributed(device="cpu", store_path=store, rank=rank,
                     world_size=world)
    flat = dict(np.load(params_path))
    tokens = torch.from_numpy(_tokens())
    saved = {}
    for label, sizes, fsdp in TRAIN[world]:
        mesh = make_mesh(("data", "seq", "model"), sizes, device_type="cpu")
        lay = ttr._layout(_tcfg(), BATCH, T, mesh, tokens.device, fsdp)
        v0 = 0 if lay.tp is None else lay.tp.axis.index * lay.tp.vocab
        saved[f"{label}.where"] = np.r_[lay.rows.start, lay.rows.stop, v0]
        saved[f"{label}.cols"] = lay.cols.numpy()
        for name, flash in (("plain", None), ("flash", True)):
            params = ttr.shard_params(
                convert.params_from_numpy(_unflat(flat)), _tcfg(), mesh,
                fsdp)
            with torch.no_grad():
                saved[f"{label}.logits.{name}"] = ttr.forward(
                    params, tokens, _tcfg(flash), mesh=mesh,
                    fsdp=fsdp).numpy()
        params = ttr.shard_params(convert.params_from_numpy(_unflat(flat)),
                                  _tcfg(), mesh, fsdp)
        for p in ttr.param_leaves(params):
            p.requires_grad_(True)
        ttr.loss_fn(params, tokens, _tcfg(), mesh=mesh, fsdp=fsdp).backward()
        for name in REPLICATED:
            leaf = (params["layers"][name] if name != "final_norm"
                    else params[name])
            saved[f"{label}.grad.{name}"] = leaf.grad.numpy().copy()
        params = ttr.shard_params(convert.params_from_numpy(_unflat(flat)),
                                  _tcfg(), mesh, fsdp)
        opt, step = ttr.make_train_step(_tcfg(), params, mesh=mesh,
                                        fsdp=fsdp)
        params, opt, loss = step(params, opt, tokens)
        saved[f"{label}.loss"] = np.asarray(loss.item())
        with torch.no_grad():
            saved.update({f"{label}.param.{k}": v
                          for k, v in _flat(params).items()})
        saved[f"{label}.coords"] = np.array(
            [ttr.mesh_coords(mesh)[a] for a in ("data", "seq", "model")])
    for label, sizes in SERVE[world]:
        mesh = make_mesh(("data", "model"), sizes, device_type="cpu")
        params = ttr.shard_params(convert.params_from_numpy(_unflat(flat)),
                                  _tcfg(), mesh)
        out = tinf.generate(params, torch.from_numpy(_prompt()), NEW,
                            _tcfg(), mesh=mesh)
        saved[f"{label}.tokens"] = out.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """{world size: [each rank's saved arrays]} of the two spawns."""
    runs = {}
    for world in (2, 8):
        d = tmp_path_factory.mktemp(f"tp_ranks{world}")
        params_path = str(d / "params.npz")
        np.savez(params_path, **_jax_params())
        spawn_ranks(world, _tp_rank, world, str(d / "store"), params_path,
                    str(d), timeout=300.0)
        runs[world] = [dict(np.load(d / f"rank{r}.npz"))
                       for r in range(world)]
    return runs


def _train_cases():
    return [(world, label, sizes, fsdp) for world, cases in TRAIN.items()
            for label, sizes, fsdp in cases]


@pytest.mark.parametrize("world,label,sizes,fsdp", _train_cases(),
                         ids=[c[1] for c in _train_cases()])
@pytest.mark.parametrize("attention", ["plain", "flash"])
def test_logits_match_jax_sharded_forward(tp_run, world, label, sizes,
                                          fsdp, attention):
    """Each rank's [B / data, T / seq, vocab / model] block, placed where
    its layout says, rebuilds the JAX package's logits."""
    got = np.full((BATCH, T, 256), np.nan, np.float32)
    for x in tp_run[world]:
        r0, r1, v0 = (int(v) for v in x[f"{label}.where"])
        block = x[f"{label}.logits.{attention}"]
        got[r0:r1, x[f"{label}.cols"], v0:v0 + block.shape[-1]] = block
    assert np.isfinite(got).all()       # every entry came from a rank
    np.testing.assert_allclose(got, _jax_logits(sizes), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)


@pytest.mark.parametrize("world,label,sizes,fsdp", _train_cases(),
                         ids=[c[1] for c in _train_cases()])
def test_loss_and_adamw_step_match_jax_sharded_step(tp_run, world, label,
                                                    sizes, fsdp):
    ref_loss, ref_params = _jax_step(sizes, fsdp)
    ranks = tp_run[world]
    losses = [float(x[f"{label}.loss"]) for x in ranks]
    assert len(set(losses)) == 1        # reduced over data x seq only
    np.testing.assert_allclose(losses[0], ref_loss, atol=STEP_ATOL,
                               rtol=STEP_RTOL)
    names = ("data", "seq", "model")
    for path, ref in ref_params.items():
        blocks = [{"block": x[f"{label}.param.{path}"],
                   "coords": dict(zip(names, map(tuple,
                                                 x[f"{label}.coords"])))}
                  for x in ranks]
        got = _assemble(blocks, path, fsdp)
        np.testing.assert_allclose(got, ref, atol=STEP_ATOL, rtol=STEP_RTOL,
                                   err_msg=f"{label} {path}")


@pytest.mark.parametrize("world,label,sizes,fsdp", _train_cases(),
                         ids=[c[1] for c in _train_cases()])
def test_replicated_leaves_get_the_same_gradient_on_every_model_rank(
        tp_run, world, label, sizes, fsdp):
    """The norms are whole on every rank of a model group, and the
    conjugate collectives give them the whole gradient there: equal to the
    bit across the group's ranks (rank = ((d x S) + s) x M + m)."""
    model = sizes[2]
    for name in REPLICATED:
        for first in range(0, world, model):
            group = [tp_run[world][first + m][f"{label}.grad.{name}"]
                     for m in range(model)]
            for g in group[1:]:
                np.testing.assert_array_equal(g, group[0], err_msg=name)


@pytest.mark.parametrize("world,label,sizes",
                         [(w, c[0], c[1]) for w, cs in SERVE.items()
                          for c in cs], ids=["gen12", "gen42"])
def test_sharded_generate_matches_jax_generate(tp_run, world, label, sizes):
    want = _jax_generate(sizes)
    for x in tp_run[world]:             # every rank returns every row
        np.testing.assert_array_equal(x[f"{label}.tokens"], want)


# --- the layout's refusals ---------------------------------------------------

class _Mesh:
    mesh_dim_names = ("data", "seq", "model")

    def __init__(self, data=1, model=1):
        self.sizes = (data, 1, model)

    def size(self, dim):
        return self.sizes[dim]

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None


def test_fsdp_data_axis_must_divide_d_model():
    with pytest.raises(ValueError, match="'data' mesh axis \\(3\\) must "
                                         "divide d_model"):
        ttr._layout(_tcfg(), 6, T, _Mesh(data=3), torch.device("cpu"),
                    fsdp=True)


def test_shard_leaf_cuts_the_specs_blocks_and_refuses_a_ragged_split():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    got = convert.shard_leaf(x, (None, None, "model"), {"model": (1, 2)})
    np.testing.assert_array_equal(got, x[:, :, 2:])
    got = convert.shard_leaf(torch.from_numpy(x), ("data", None, "model"),
                             {"data": (1, 2), "model": (0, 4)})
    assert torch.equal(got, torch.from_numpy(x[1:, :, :1]))
    with pytest.raises(ValueError, match="does not divide"):
        convert.shard_leaf(x, (None, "data", None), {"data": (0, 2)})
