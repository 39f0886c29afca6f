"""The LM substrate's training on a mesh: 4 gloo ranks on the CPU, against
the port's one-device step and the reference on 4 host devices.

For a reduced dense (internlm2) and a reduced MoE (deepseek-v3, capacity
factor 0.5, so that pairs drop) config in float32, on the (4, 1) and
(2, 2) ``("data", "model")`` meshes: one ``make_train_step`` step with the
state placed by ``specs.state_pspecs`` and the batch by
``specs.batch_pspecs``.  Held to the training tests' tolerances: the loss
within 1e-5, each gradient within rtol 1e-4 / atol 1e-5, each parameter
after the step within the same or, where the reference's |g| lies within
the gradient tolerance of 0, within 2 lr (the first AdamW step is about
lr * sign(g)).
The mesh's rounding order differs from one device's (sharded products,
the global norm's reduction), hence tolerances rather than bits.  The
reference runs in one JAX subprocess with 4 host devices (XLA capped at
AVX), under ``use_mesh(make_host_mesh())``; the port's ranks are spawned
processes meeting at a ``file://`` rendezvous under ``tmp_path``.  The
MoE's routes and capacity drops on the mesh equal the one-device run's.

Also: a checkpoint saved on (4, 1) restores onto (2, 2) and onto one
device bit for bit, and ``launch.train`` under ``torchrun --standalone
--nproc-per-node 2 ... --device cpu --reduced``, checkpointed and resumed,
ends with the uninterrupted run's state, bit for bit.

Sharded products round once: in bf16, a row-parallel ``matmul`` (K split
over 4 ranks, and over ``model`` on (2, 2)) and a ``bmatmul`` whose weight
is split on K match one device but on at most 0.1% of the elements, with a
mean error against float64 within 1.05x one device's, and no output is a
bf16 partial.  A mesh prefill keeps ``prefill_chunks``: dbrx and deepseek
reduced in float32 (B 8 x S 64, 8 chunks) on (4, 1) and (2, 2) give the
logits, caches and one decode step after them of one device's chunked
prefill and of the reference's (1e-4), with its routes and drops; the
decode step with its tokens replicated on every axis (the dry run's
placement) gives the logits and cache of the step with them sharded as
the batch (1e-4).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.checkpoint import CheckpointManager, flatten_state
from repro_torch.configs import get_config
from repro_torch.convert import load_reference_tree
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.optim import AdamW
from repro_torch.train.step import TrainStepConfig, make_train_step

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("internlm2-1.8b", "deepseek-v3-671b")
MESHES = ((4, 1), (2, 2))
B, S, LR = 8, 32, 1e-3
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PREFILL_ARCHS = ("dbrx-132b", "deepseek-v3-671b")
PB, PS = 8, 64                  # the prefill's batch: 8 chunks of one row
PREFILL_TOL = dict(rtol=0, atol=1e-4)
PRODUCTS = ("matmul_4", "matmul_2x2", "bmatmul_4")


def prefill_cfg(get, arch):
    """A MoE arch reduced, in float32, ``prefill_chunks`` as reduced()
    leaves it (8) and its own capacity factor, so that chunks drop pairs."""
    return get(arch).reduced().replace(dtype="float32")


def prefill_batch(cfg, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, cfg.vocab_size, (PB, PS)).astype(np.int32),
            rng.randint(0, cfg.vocab_size, (PB, 1)).astype(np.int32))


def product_inputs(name):
    """bf16 operands of a sharded product (numpy draws, seed 0)."""
    rng = np.random.RandomState(0)
    if name.startswith("matmul"):
        a, b = rng.randn(256, 1024), rng.randn(1024, 512) / 32
    else:
        a, b = rng.randn(2, 128, 1024), rng.randn(2, 1024, 256) / 32
    return (torch.from_numpy(a.astype(np.float32)).bfloat16(),
            torch.from_numpy(b.astype(np.float32)).bfloat16())


def reduced(get, arch):
    cfg = get(arch).reduced().replace(remat="nothing", dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=0.5))
    return cfg


def make_batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def to_torch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def unflatten(flat, prefix):
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = tree
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


_JAX_MESH = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.distributed.sharding import use_mesh, activation_dp_over_model
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.optim import AdamW
from repro.train.step import TrainStepConfig, make_train_step

def flat(tree, prefix):
    out = {{}}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out

out = {{"devices": np.asarray(len(jax.devices()))}}
for arch in {archs!r}:
    cfg = get_config(arch).reduced().replace(remat="nothing",
                                             dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=0.5))
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    batch = {{"tokens": rng.randint(0, cfg.vocab_size, ({b}, {s})).astype(
                  np.int32),
              "labels": rng.randint(0, cfg.vocab_size, ({b}, {s})).astype(
                  np.int32)}}
    opt = AdamW()
    step = make_train_step(model, opt, TrainStepConfig(learning_rate={lr}))

    def run(params, batch):
        (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(
            params, batch)
        state = {{"params": params, "opt": opt.init(params),
                  "step": jnp.zeros((), jnp.int32)}}
        new, _ = step(state, batch)
        return loss, grads, new["params"]

    with use_mesh(make_host_mesh()), \\
            activation_dp_over_model(cfg.dp_over_model):
        loss, grads, new = jax.jit(run)(
            params, {{k: jnp.asarray(v) for k, v in batch.items()}})
    out[arch + "/loss"] = np.asarray(loss)
    out.update(flat(jax.device_get(params), arch + "/params/"))
    out.update(flat(jax.device_get(grads), arch + "/grads/"))
    out.update(flat(jax.device_get(new), arch + "/new/"))

# the chunked prefill (lax.map over prefill_chunks) and one decode step
for arch in {prefill_archs!r}:
    cfg = get_config(arch).reduced().replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size, ({pb}, {ps})).astype(np.int32)
    nxt = rng.randint(0, cfg.vocab_size, ({pb}, 1)).astype(np.int32)
    logits, cache = jax.jit(model.prefill)(params,
                                           {{"tokens": jnp.asarray(tokens)}})
    full = jax.tree_util.tree_map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 1)]
                          + [(0, 0)] * (a.ndim - 3)), cache)
    step, _ = jax.jit(model.decode_step)(params, full, jnp.asarray(nxt),
                                         jnp.int32({ps}))
    key = "prefill/" + arch
    out.update(flat(jax.device_get(params), key + "/params/"))
    out[key + "/logits"] = np.asarray(logits)
    out.update(flat(jax.device_get(cache), key + "/cache/"))
    out[key + "/decode"] = np.asarray(step)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's initial parameters, loss, gradients and parameters
    after one step, per arch, on 4 host devices (one JAX process)."""
    root = tmp_path_factory.mktemp("jax_lm_mesh")
    code = _JAX_MESH.format(archs=ARCHS, b=B, s=S, lr=LR,
                            prefill_archs=PREFILL_ARCHS, pb=PB, ps=PS)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_max_isa=AVX")
    done = subprocess.run([sys.executable, "-c", code, str(root / "ref.npz")],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    with np.load(root / "ref.npz") as z:
        out = {k: z[k] for k in z.files}
    assert int(out["devices"]) == 4
    out["root"] = root
    return out


def port_model(arch, ref):
    cfg = reduced(get_config, arch)
    return cfg, load_reference_tree(build_model(cfg, "cpu"),
                                    unflatten(ref, arch + "/params/"))


def prefill_model(arch, ref):
    cfg = prefill_cfg(get_config, arch)
    return cfg, load_reference_tree(
        build_model(cfg, "cpu"), unflatten(ref, f"prefill/{arch}/params/"))


def moe_blocks(model):
    return [m for m in model.modules() if hasattr(m, "routes")]


def flat_cache(cache, prefix=""):
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(flat_cache(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def padded(cache):
    """A prefill's cache [L, B, S, ...] with one more (empty) slot for a
    decode step."""
    if isinstance(cache, dict):
        return {k: padded(v) for k, v in cache.items()}
    pad = torch.zeros_like(cache[:, :, :1])
    return torch.cat([cache, pad], dim=2)


def _products(mesh4, mesh22, out):
    """F1's sharded bf16 products; their full values and whether a bf16
    partial left them."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    cases = {"matmul_4": (mesh4, L.matmul, [Shard(1)], [Shard(0)]),
             "matmul_2x2": (mesh22, L.matmul, [Shard(0), Shard(1)],
                            [Replicate(), Shard(0)]),
             "bmatmul_4": (mesh4, L.bmatmul, [Replicate()], [Shard(1)])}
    for name, (mesh, fn, pa, pb) in cases.items():
        a, b = product_inputs(name)
        got = fn(distribute_tensor(a, mesh, pa), distribute_tensor(b, mesh,
                                                                   pb))
        out[f"product/{name}/partial_bf16"] = np.asarray(
            got.dtype == torch.bfloat16
            and any(p.is_partial() for p in got.placements))
        out[f"product/{name}"] = got.full_tensor().float().numpy()


def _prefill_on_mesh(mesh, arch, ref, key, out):
    """A chunked prefill and one decode step after it on ``mesh``."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import specs as SP
    cfg, model = prefill_model(arch, ref)
    tokens, nxt = (torch.from_numpy(t).long() for t in prefill_batch(cfg))
    SH.shard_module(model, mesh, SP.to_named(SP.params_pspecs(
        SP.params_abstract(model), mesh, serving=True), mesh))
    batch = {"tokens": tokens}
    batch = SH.distribute(batch, SP.to_named(SP.batch_pspecs(batch, mesh),
                                             mesh), mesh)
    for m in moe_blocks(model):
        m.routes = []
    logits, cache = model.prefill(batch)
    for j, m in enumerate(moe_blocks(model)):
        for c, (idx, keep) in enumerate(m.routes):
            out[f"{key}/routes/{j}/{c}/idx"] = idx.numpy()
            out[f"{key}/routes/{j}/{c}/keep"] = keep.numpy()
        m.routes = None
    out[key + "/logits"] = logits.full_tensor().numpy()
    cache = {k: v.full_tensor() for k, v in flat_cache(cache).items()}
    for k, v in cache.items():
        out[f"{key}/cache/{k}"] = v.numpy()
    from torch.distributed.tensor import Replicate, distribute_tensor
    sharded = SH.distribute({"tokens": nxt}, SP.to_named(SP.batch_pspecs(
        {"tokens": nxt}, mesh), mesh), mesh)["tokens"]
    # the dry run's placement of decode tokens, the reference's
    # in_shardings of None: replicated on every axis
    replicated = distribute_tensor(nxt, mesh.device_mesh,
                                   [Replicate()] * len(mesh.dims))
    for name, tok in (("decode", sharded), ("decode_replicated",
                                            replicated)):
        full = padded(unflatten(cache, ""))
        full = SH.distribute(full, SP.to_named(SP.cache_pspecs(
            full, mesh, batch_size=PB, max_seq=PS + 1, cfg=cfg), mesh), mesh)
        step, after = model.decode_step(full, tok, PS)
        out[f"{key}/{name}"] = step.full_tensor().numpy()
        for k, v in flat_cache(after).items():
            out[f"{key}/{name}_cache/{k}"] = v.full_tensor().numpy()


def _worker(rank, world, rdzv, ref_path, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import specs as SP
    from repro_torch.launch.train import place_state
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                            world_size=world)
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    out = {}
    meshes = {}
    for shape in MESHES:
        tag = "x".join(map(str, shape))
        mesh = meshes[shape] = SH.LMMesh.from_device_mesh(init_device_mesh(
            "cpu", shape, mesh_dim_names=("data", "model")))
        for arch in PREFILL_ARCHS:
            cfg = prefill_cfg(get_config, arch)
            with SH.use_mesh(mesh), \
                    SH.activation_dp_over_model(cfg.dp_over_model), \
                    implicit_replication():
                _prefill_on_mesh(mesh, arch, ref, f"prefill/{tag}/{arch}",
                                 out)
        for arch in ARCHS:
            cfg, model = port_model(arch, ref)
            opt = AdamW()
            with SH.use_mesh(mesh), \
                    SH.activation_dp_over_model(cfg.dp_over_model), \
                    implicit_replication():
                state, shardings = place_state(model, opt, TrainStepConfig(),
                                               mesh)
                batch = to_torch(make_batch(cfg))
                batch = SH.distribute(batch, SP.to_named(
                    SP.batch_pspecs(batch, mesh), mesh), mesh)
                for m in moe_blocks(model):
                    m.routes = []
                loss, _ = model.loss(batch)
                params = state["params"]
                grads = torch.autograd.grad(loss, list(params.values()))
                seen = [m.routes for m in moe_blocks(model)]
                for m in moe_blocks(model):
                    m.routes = None
                key = f"{tag}/{arch}"
                out[key + "/loss"] = loss.full_tensor().detach().numpy()
                for (k, p), g in zip(params.items(), grads):
                    out[f"{key}/grads/{k}"] = g.full_tensor().numpy()
                for j, ((idx, keep),) in enumerate(seen):
                    out[f"{key}/routes/{j}/idx"] = idx.numpy()
                    out[f"{key}/routes/{j}/keep"] = keep.numpy()
                step = make_train_step(model, opt,
                                       TrainStepConfig(learning_rate=LR))
                state, metrics = step(state, batch)
                out[key + "/step_loss"] = metrics["loss"].numpy()
                for k, p in state["params"].items():
                    out[f"{key}/new/{k}"] = p.full_tensor().detach().numpy()
                if arch == ARCHS[0]:
                    ck = CheckpointManager(Path(out_dir) / "ckpt")
                    if shape == MESHES[0]:
                        ck.save(state, 1)        # every rank; rank 0 writes
                        dist.barrier()
                    else:   # the (4, 1) checkpoint onto this mesh
                        restored, _ = ck.restore(state, shardings=shardings,
                                                 mesh=mesh)
                        for k, t in flatten_state(restored):
                            assert t.placements == _at(shardings, k), k
                            out[f"restored/{k}"] = t.full_tensor().numpy()
    _products(init_device_mesh("cpu", (world,)),
              meshes[(2, 2)].device_mesh, out)
    if rank == 0:
        np.savez(Path(out_dir) / "port.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


def _at(tree, key):
    for part in key.split("/"):
        tree = tree[part]
    return tuple(tree)


def worker(rank, *args):
    import traceback
    try:
        _worker(rank, *args)
    except BaseException:
        traceback.print_exc()
        raise


@pytest.fixture(scope="module")
def port_mesh(reference, tmp_path_factory):
    """Every mesh result of the port, from one spawn of 4 gloo ranks."""
    root = tmp_path_factory.mktemp("port_lm_mesh")
    ref_path = root / "ref.npz"
    np.savez(ref_path, **{k: v for k, v in reference.items()
                          if k != "root"})
    mp.start_processes(worker, args=(4, "file://" + str(root / "rdzv"),
                                     str(ref_path), str(root)),
                       nprocs=4, join=True, start_method="spawn")
    with np.load(root / "port.npz") as z:
        out = {k: z[k] for k in z.files}
    out["root"] = root
    return out


def one_device(arch, ref):
    """The port's one-device loss, grads, routes and step."""
    cfg, model = port_model(arch, ref)
    for m in moe_blocks(model):
        m.routes = []
    batch = to_torch(make_batch(cfg))
    loss, _ = model.loss(batch)
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    routes = [m.routes[0] for m in moe_blocks(model)]
    for m in moe_blocks(model):
        m.routes = None
    opt = AdamW()
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    state, _ = make_train_step(model, opt, TrainStepConfig(
        learning_rate=LR))(state, batch)
    new = {k: p.detach().numpy() for k, p in state["params"].items()}
    return float(loss), {k: g.numpy() for k, g in grads.items()}, routes, new


def ref_leaf(flat, prefix, name):
    parts = name.split(".")
    idx = tuple(int(x) for x in parts if x.isdigit())
    return flat[prefix + "/".join(x for x in parts if not x.isdigit())][idx]


def assert_step(got_loss, got_grads, got_new, want_loss, want_grad,
                want_new):
    np.testing.assert_allclose(got_loss, want_loss, **LOSS_TOL)
    for name, g in got_grads.items():
        w = want_grad(name)
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)
        flip = np.abs(w) <= GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(w)
        got, want = got_new[name], want_new(name)
        np.testing.assert_allclose(got[~flip], want[~flip], **GRAD_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(got[flip], want[flip], rtol=0,
                                   atol=2 * LR, err_msg=name)


def _mesh_view(port, tag, arch):
    key = f"{tag}/{arch}"
    grads = {k[len(key) + 7:]: v for k, v in port.items()
             if k.startswith(key + "/grads/")}
    new = {k[len(key) + 5:]: v for k, v in port.items()
           if k.startswith(key + "/new/")}
    return float(port[key + "/loss"]), grads, new


CASES = [(a, "x".join(map(str, m))) for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,tag", CASES)
def test_mesh_step_matches_one_device(port_mesh, reference, arch, tag):
    loss, grads, new = _mesh_view(port_mesh, tag, arch)
    want_loss, want_grads, _, want_new = one_device(arch, reference)
    assert set(grads) == set(want_grads)
    assert_step(loss, grads, new, want_loss, want_grads.__getitem__,
                want_new.__getitem__)


@pytest.mark.parametrize("arch,tag", CASES)
def test_mesh_step_matches_reference(port_mesh, reference, arch, tag):
    loss, grads, new = _mesh_view(port_mesh, tag, arch)
    assert_step(loss, grads, new, float(reference[arch + "/loss"]),
                lambda n: ref_leaf(reference, arch + "/grads/", n),
                lambda n: ref_leaf(reference, arch + "/new/", n))


@pytest.mark.parametrize("tag", ["4x1", "2x2"])
def test_moe_drops_equal_one_device(port_mesh, reference, tag):
    arch = ARCHS[1]
    _, _, routes, _ = one_device(arch, reference)
    assert routes
    dropped = 0
    for j, (idx, keep) in enumerate(routes):
        key = f"{tag}/{arch}/routes/{j}"
        np.testing.assert_array_equal(port_mesh[key + "/idx"], idx.numpy())
        np.testing.assert_array_equal(port_mesh[key + "/keep"],
                                      keep.numpy())
        dropped += int((~keep).sum())
    assert dropped > 0, "no pair dropped at this capacity"


def test_elastic_restore_bitwise(port_mesh, reference):
    """Saved on (4, 1), restored onto (2, 2) in the ranks and onto one
    device here: the (4, 1) state's logical tensors, bit for bit."""
    arch = ARCHS[0]
    restored = {k[9:]: v for k, v in port_mesh.items()
                if k.startswith("restored/")}
    assert restored
    for k, v in restored.items():
        if k.startswith("params/"):
            np.testing.assert_array_equal(
                v, port_mesh[f"4x1/{arch}/new/{k[7:]}"], err_msg=k)
    cfg, model = port_model(arch, reference)
    params = dict(model.named_parameters())
    target = {"params": params, "opt": AdamW().init(params),
              "step": torch.zeros((), dtype=torch.int32)}
    one, step = CheckpointManager(port_mesh["root"] / "ckpt").restore(target)
    assert step == 1
    for k, t in flatten_state(one):
        np.testing.assert_array_equal(t.detach().numpy(), restored[k],
                                      err_msg=k)


def _torchrun(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    done = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--reduced", "--batch", "4", "--seq", "16",
         "--log-every", "1"] + args, env=env, cwd=cwd, capture_output=True,
        text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    return done.stdout


def test_launch_train_torchrun_resume(tmp_path):
    """Two ranks of ``launch.train`` (the (2, 1) host mesh over gloo): 6
    steps uninterrupted, checkpointed at 3 and 6; a resume from its step-3
    checkpoint to 6 ends with its step-6 state, bit for bit."""
    import shutil
    full, part = tmp_path / "full", tmp_path / "part"
    out = _torchrun(["--steps", "6", "--ckpt-dir", str(full),
                     "--ckpt-every", "3"], tmp_path)
    assert "mesh={'data': 2, 'model': 1}" in out, out
    part.mkdir()
    shutil.copytree(full / "step_0000000003", part / "step_0000000003")
    out = _torchrun(["--steps", "6", "--ckpt-dir", str(part), "--resume"],
                    tmp_path)
    assert "[resume] restored step 3" in out, out
    a = np.load(full / "step_0000000006" / "tensors.npz")
    b = np.load(part / "step_0000000006" / "tensors.npz")
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", PRODUCTS)
def test_sharded_product_rounds_once(port_mesh, name):
    """A product summed over ranks is reduced in fp32 and rounded once (as
    XLA compiles the reference's): one device's result but on a handful of
    elements, and no output is a bf16 partial."""
    a, b = product_inputs(name)
    fn = L.bmatmul if name.startswith("bmatmul") else L.matmul
    one = fn(a, b).float().numpy()
    got = port_mesh[f"product/{name}"]
    assert not port_mesh[f"product/{name}/partial_bf16"]
    assert got.shape == one.shape
    exact = (a.double() @ b.double()).numpy()
    differ = int((got != one).sum())
    assert differ <= one.size // 1000, (differ, one.size)
    err, err_one = np.abs(got - exact).mean(), np.abs(one - exact).mean()
    assert err <= 1.05 * err_one, (err, err_one)


def one_device_prefill(arch, ref):
    """The port's one-device chunked prefill, its routes and one decode
    step after it."""
    cfg, model = prefill_model(arch, ref)
    tokens, nxt = (torch.from_numpy(t).long() for t in prefill_batch(cfg))
    for m in moe_blocks(model):
        m.routes = []
    logits, cache = model.prefill({"tokens": tokens})
    routes = [list(m.routes) for m in moe_blocks(model)]
    for m in moe_blocks(model):
        m.routes = None
    step, _ = model.decode_step(padded(cache), nxt, PS)
    return (logits.numpy(), {k: v.numpy() for k, v in
                             flat_cache(cache).items()}, step.numpy(), routes)


PREFILL_CASES = [(a, "x".join(map(str, m))) for a in PREFILL_ARCHS
                 for m in MESHES]


def _prefill_view(port, tag, arch):
    key = f"prefill/{tag}/{arch}"
    cache = {k[len(key) + 7:]: v for k, v in port.items()
             if k.startswith(key + "/cache/")}
    return port[key + "/logits"], cache, port[key + "/decode"]


def _assert_prefill(got, want):
    (lg, cache, step), (wlg, wcache, wstep) = got, want
    np.testing.assert_allclose(lg, wlg, **PREFILL_TOL)
    assert set(cache) == set(wcache)
    for k in cache:
        np.testing.assert_allclose(cache[k], wcache[k], **PREFILL_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(step, wstep, **PREFILL_TOL)


@pytest.mark.parametrize("arch,tag", PREFILL_CASES)
def test_mesh_prefill_matches_one_device_chunks(port_mesh, reference, arch,
                                                tag):
    logits, cache, step, _ = one_device_prefill(arch, reference)
    _assert_prefill(_prefill_view(port_mesh, tag, arch), (logits, cache,
                                                          step))


@pytest.mark.parametrize("arch,tag", PREFILL_CASES)
def test_mesh_prefill_matches_reference(port_mesh, reference, arch, tag):
    key = "prefill/" + arch
    cache = {k[len(key) + 7:]: v for k, v in reference.items()
             if k.startswith(key + "/cache/")}
    _assert_prefill(_prefill_view(port_mesh, tag, arch),
                    (reference[key + "/logits"], cache,
                     reference[key + "/decode"]))


@pytest.mark.parametrize("arch,tag", PREFILL_CASES)
def test_mesh_decode_replicated_tokens(port_mesh, arch, tag):
    """A decode step whose tokens are replicated on every mesh axis (the
    dry run's placement, the reference's ``in_shardings`` of None) gives
    the logits and cache of the step with tokens sharded as the batch."""
    key = f"prefill/{tag}/{arch}"
    np.testing.assert_allclose(port_mesh[key + "/decode_replicated"],
                               port_mesh[key + "/decode"], **PREFILL_TOL)
    names = [k[len(key) + 14:] for k in port_mesh
             if k.startswith(key + "/decode_cache/")]
    assert names
    for k in names:
        np.testing.assert_allclose(
            port_mesh[f"{key}/decode_replicated_cache/{k}"],
            port_mesh[f"{key}/decode_cache/{k}"], **PREFILL_TOL, err_msg=k)


@pytest.mark.parametrize("arch,tag", PREFILL_CASES)
def test_mesh_prefill_drops_equal_one_device(port_mesh, reference, arch,
                                             tag):
    *_, routes = one_device_prefill(arch, reference)
    dropped = 0
    for j, chunks in enumerate(routes):
        assert len(chunks) == prefill_cfg(get_config, arch).prefill_chunks
        for c, (idx, keep) in enumerate(chunks):
            key = f"prefill/{tag}/{arch}/routes/{j}/{c}"
            np.testing.assert_array_equal(port_mesh[key + "/idx"],
                                          idx.numpy())
            np.testing.assert_array_equal(port_mesh[key + "/keep"],
                                          keep.numpy())
            dropped += int((~keep).sum())
        assert f"prefill/{tag}/{arch}/routes/{j}/{len(chunks)}/idx" \
            not in port_mesh
    assert dropped > 0, "no pair dropped at this capacity"
