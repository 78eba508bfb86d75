"""Spawn ``n`` gloo ranks on the CPU for a test of the port's process-group
path, and the functions those ranks run.

:func:`spawn` runs ``fn(rank, n, *args)`` in ``n`` gloo ranks through
:func:`repro_torch.multiproc.spawn`, with the ``file://`` store in the
test's own directory (no TCP port, so parallel test workers never
collide) and a timeout per spawn: a rank that raises fails the test with
its traceback, and a run that outlasts ``timeout`` seconds (a collective
posted by some ranks only would otherwise hang) is killed and fails it.

The rank functions live here, not in the test modules, so that a spawned
rank imports torch and the port only — never JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import multiproc

__all__ = ["spawn", "COMM_CALLS", "comm_inputs", "comm_pairs", "comm_call", "comm_input",
           "comm_calls", "snn_runs", "hierarchical_calls", "gpipe_rank", "sharded_train_steps",
           "launcher_rank", "POLICY_VARIANTS", "ROLES", "OFFSET_SHAPE", "OFFSET_ROLES",
           "policy_layouts"]


def spawn(fn, n: int, tmp_path, *args, timeout: float = 120.0) -> list:
    """``[fn(rank, n, *args) for rank in range(n)]``, each in its own gloo
    rank on the CPU."""
    return multiproc.spawn(fn, n, *args, backend="gloo", device="cpu", timeout=timeout,
                           workdir=tmp_path)


# -- ProcessGroupComm, method by method --------------------------------------

#: ``(name, method, axis or pairs)`` — each call of :func:`comm_calls`,
#: one ledger step each
COMM_CALLS = (
    ("all_gather/inner", "all_gather", "inner"),
    ("all_gather/slow", "all_gather", "slow"),
    ("all_gather/joint", "all_gather", "joint"),
    ("psum/inner", "psum", "inner"),
    ("psum/slow", "psum", "slow"),
    ("psum/joint", "psum", "joint"),
    ("all_to_all/inner", "all_to_all", "inner"),
    ("all_to_all/slow", "all_to_all", "slow"),
    ("all_to_all/joint", "all_to_all", "joint"),
    ("psum_scatter/inner", "psum_scatter", "inner"),
    ("psum_scatter/slow", "psum_scatter", "slow"),
    ("psum_scatter/joint", "psum_scatter", "joint"),
    ("ppermute/slow", "ppermute", "slow"),
    ("ppermute/joint", "ppermute", "joint"),
    ("collect", "collect", None),
)


def comm_inputs(mesh: tuple[int, ...], seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded rank-stacked inputs ``[n_dev, ...]`` for each call: integer
    values in float32, so every sum is exact in any order."""
    n = int(np.prod(mesh))
    rng = np.random.default_rng(seed)

    def ints(*shape):
        return rng.integers(-50, 50, size=(n, *shape)).astype(np.float32)

    blocks = 2 * n  # divisible by every axis group's size
    return {"flat": ints(3, 2), "sum": ints(blocks, 3), "blocks": ints(blocks, 2)}


def comm_pairs(mesh: tuple[int, ...]) -> dict[str, tuple]:
    """ppermute pairs: a shift across groups (``"slow"``) and a partial
    rank permutation that leaves some ranks untargeted (``"joint"``)."""
    g = mesh[0]
    n = int(np.prod(mesh))
    slow = tuple((s, (s + 1) % g) for s in range(g))
    joint = tuple((s, (s + 3) % n) for s in range(0, n, 2))
    return {"slow": slow, "joint": joint}


def comm_call(comm, method: str, arg, x: torch.Tensor, pairs: dict) -> torch.Tensor:
    """One call of :data:`COMM_CALLS` on ``x`` (the rows ``comm`` holds)."""
    if method == "collect":
        return comm.collect(x)
    if method == "ppermute":
        return comm.ppermute(x, pairs[arg], arg)
    if method == "all_to_all":
        k = len(comm.members(arg, comm.ranks.start))
        return getattr(comm, method)(x.reshape(x.shape[0], k, -1, *x.shape[2:]), arg)
    return getattr(comm, method)(x, arg)


def comm_input(inputs: dict, method: str) -> np.ndarray:
    return inputs["flat"] if method in ("all_gather", "ppermute", "collect") else (
        inputs["sum"] if method in ("psum", "psum_scatter") else inputs["blocks"])


def comm_calls(rank: int, n: int, mesh: tuple[int, ...], inputs: dict, pairs: dict) -> dict:
    """Every call of :data:`COMM_CALLS` through a gloo ``ProcessGroupComm``
    on this rank's row of ``inputs``; the results, the rank's ledger and
    the summed one."""
    from repro_torch.snn import ProcessGroupComm

    comm = ProcessGroupComm(mesh, "gloo", "cpu")
    assert comm.ranks == range(rank, rank + 1) and not comm.capturable
    out = {}
    for name, method, arg in COMM_CALLS:
        comm.new_step()
        x = torch.from_numpy(comm_input(inputs, method)[rank:rank + 1].copy())
        out[name] = comm_call(comm, method, arg, x, pairs).numpy()
    return {"results": out, "step_bytes": list(comm.step_bytes),
            "ledger_total": comm.ledger_total()}


# -- the distributed engine ---------------------------------------------------


def snn_runs(rank: int, n: int, mesh: tuple[int, ...], w: np.ndarray, drive: np.ndarray,
             configs: tuple, steps: int) -> dict:
    """``DistributedSNN`` over a gloo ``ProcessGroupComm`` for each
    ``(exchange, noise_sigma)`` of ``configs`` under the per-neuron
    ``drive`` (or ``(exchange, noise_sigma, i_ext)`` under the scalar
    ``i_ext``): the rank's raster, the gathered global raster, the rank's
    ledger and the summed one."""
    from repro_torch import convert
    from repro_torch.snn import (
        BlockSynapses, DistributedSNN, LIFParams, ProcessGroupComm, gather_raster,
    )

    syn = BlockSynapses.from_dense(w, n)
    out = {}
    for config in configs:
        exchange, noise = config[:2]
        kw = {"w_syn": w} if exchange in ("flat", "two_level") else {"syn": syn}
        eng = DistributedSNN(mesh=mesh, params=LIFParams(noise_sigma=noise),
                             exchange=exchange, i_ext=drive if len(config) == 2 else config[2],
                             device="cpu", **kw)
        comm = ProcessGroupComm(mesh, "gloo", "cpu")
        local = eng.run(steps, seed=3, comm=comm)
        out[config] = {
            "local": local.numpy(), "raster": gather_raster(local, comm).numpy(),
            "step_bytes": list(comm.step_bytes), "ledger_total": comm.ledger_total(),
        }
    # tiles staged by the caller for the rank held (tile_ranks names them),
    # and another rank's tiles, which the engine must refuse
    held, other = range(rank, rank + 1), range((rank + 1) % n, (rank + 1) % n + 1)
    comm = ProcessGroupComm(mesh, "gloo", "cpu")
    own = DistributedSNN(mesh=mesh, params=LIFParams(), exchange="sparse", i_ext=drive,
                         syn=syn, device="cpu", tiles=convert.padded_tiles(syn, "cpu", ranks=held),
                         tile_ranks=held)
    out["own_tiles"] = gather_raster(own.run(steps, seed=3, comm=comm), comm).numpy()
    wrong = DistributedSNN(mesh=mesh, params=LIFParams(), exchange="sparse", i_ext=drive,
                           syn=syn, device="cpu", tiles=convert.padded_tiles(syn, "cpu", ranks=other),
                           tile_ranks=other)
    try:
        wrong.run(steps, seed=3, comm=comm)
        out["other_tiles"] = "ran"
    except ValueError as e:
        out["other_tiles"] = str(e)
    return out


# -- the hierarchical collectives ----------------------------------------------


def hierarchical_calls(rank: int, n: int, mesh: tuple[int, ...], a2a: np.ndarray,
                       grad: np.ndarray, shards: np.ndarray) -> dict:
    """``repro_torch.core.hierarchical`` over a gloo ``ProcessGroupComm``
    on this rank's part of ``tests/test_hierarchical.py``'s inputs."""
    from repro_torch.core import hierarchical as h
    from repro_torch.snn import ProcessGroupComm

    comm = ProcessGroupComm(mesh, "gloo", "cpu")
    flat, two = h.make_exchange_fns(comm)
    x = torch.from_numpy(a2a[rank:rank + 1].copy())
    g = torch.from_numpy(grad[None].copy())  # replicated on every rank
    s = torch.from_numpy(shards[rank:rank + 1].copy())
    return {"flat": flat(x).numpy(), "two_level": two(x).numpy(),
            "hierarchical_psum": h.hierarchical_psum(g, comm).numpy(),
            "flat_psum": h.flat_psum(g, comm).numpy(),
            "two_level_all_gather": h.two_level_all_gather(s, comm).numpy(),
            "ledger_total": comm.ledger_total()}


# -- the sharding layer ---------------------------------------------------------


def gpipe_rank(rank: int, n: int, w: np.ndarray, b: np.ndarray, x: np.ndarray,
               n_microbatches: int) -> np.ndarray:
    """``repro_torch.sharding.gpipe`` over a gloo ``ProcessGroupComm`` on a
    ``(n,)`` mesh, this rank holding stage ``rank``: ``tanh(h @ w + b)`` a
    stage (``tests/test_pipeline.py``'s stage function)."""
    from repro_torch.sharding import gpipe
    from repro_torch.snn import ProcessGroupComm

    comm = ProcessGroupComm((n,), "gloo", "cpu")
    run = gpipe(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), comm,
                n_microbatches=n_microbatches)
    own = {"w": torch.from_numpy(w[rank:rank + 1].copy()),
           "b": torch.from_numpy(b[rank:rank + 1].copy())}
    return run(own, torch.from_numpy(x)).numpy()


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def sharded_train_steps(rank: int, n: int, cases: list, seq: int, batch: int) -> list:
    """One train step (2 microbatches; float32: ``make_train_step``, bf16:
    its ``make_grad_fn`` and ``adamw_update``) of each ``(arch, compute
    dtype, flat params[, make_policy kwargs])`` case under ``make_policy`` on a ``(n // 2, 2)``
    ``("data", "model")`` mesh of gloo ranks, from the given params (float32
    numpy, keyed by path): the loss, ``grad_norm``, the updated params and
    master gathered (rank 0), every leaf's local shape, the collectives
    ``CommDebugMode`` saw, under bf16 compute the gathered gradients
    (rank 0); and, on rank 0, the port's one-process step and gradients on
    the same params and batch."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import convert
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import layers, lm
    from repro_torch.sharding import make_policy
    from repro_torch.train import (AdamWConfig, TrainStepConfig, adamw_update, init_opt_state,
                                   make_grad_fn, make_train_step)
    from repro_torch.train.optimizer import tree_leaves, tree_map

    mesh = init_device_mesh("cpu", (n // 2, 2), mesh_dim_names=("data", "model"))
    ts = TrainStepConfig(n_microbatches=2, adamw=AdamWConfig(warmup_steps=2, total_steps=50))
    out = []
    for arch, dtype, flat, *kw in cases:
        pol = make_policy(mesh, **(kw[0] if kw else {}))
        layers.COMPUTE_DTYPE = getattr(torch, dtype)
        cfg = ARCHS[arch].reduced()
        params = convert.lm_params(_unflatten(flat), cfg, "cpu")
        if dtype == "float32":
            params = tree_map(lambda t: t.float(), params)
        data = {k: torch.from_numpy(v) for k, v in SyntheticLM(
            cfg, DataConfig(seq_len=seq, global_batch=batch))(0).items()}
        sharded = lm.distribute_params(tree_map(lambda t: t.clone(), params), cfg, pol)
        with CommDebugMode() as comm:
            if dtype == "float32":
                loss, new, opt, metrics = make_train_step(cfg, ts, pol)(
                    sharded, init_opt_state(sharded), data)
            else:  # the step's two halves, to keep its gradients (held by cosine)
                loss, grads = make_grad_fn(cfg, 2, pol)(sharded, data)
                new, opt, metrics = adamw_update(sharded, grads, init_opt_state(sharded),
                                                 ts.adamw)
                grads = [g.full_tensor().float().numpy() for g in tree_leaves(grads)]
        res = {"arch": arch, "dtype": dtype, "loss": float(loss),
               "grad_norm": float(metrics["grad_norm"]),
               "comm": {str(k): v for k, v in comm.get_comm_counts().items()},
               "local_shapes": [tuple(t.to_local().shape) for t in tree_leaves(new)],
               "shapes": [tuple(t.shape) for t in tree_leaves(new)],
               "placements": [str(tuple(t.placements)) for t in tree_leaves(new)]}
        full = [t.full_tensor().float().numpy() for t in tree_leaves(new)]
        master = [t.full_tensor().numpy() for t in tree_leaves(opt["master"])]
        if rank == 0:
            res.update(params=full, master=master)
            if dtype == "bfloat16":
                res["grads"] = grads
            _, grads = make_grad_fn(cfg, 2)(params, data)
            res["plain_grads"] = [g.float().numpy() for g in tree_leaves(grads)]
            ploss, pnew, popt, pmet = make_train_step(cfg, ts)(params, init_opt_state(params),
                                                            data)
            res.update(plain_loss=float(ploss), plain_grad_norm=float(pmet["grad_norm"]),
                       plain_params=[t.float().numpy() for t in tree_leaves(pnew)],
                       plain_master=[t.numpy() for t in tree_leaves(popt["master"])])
        out.append(res)
    return out


# -- the sharding policy on fake process groups ---------------------------------

#: policy variants held to the reference's: (name, multi-pod mesh, make_policy kwargs)
POLICY_VARIANTS = (
    ("single", False, {}),
    ("single/gather", False, {"attn_mode": "gather"}),
    ("multi", True, {}),
    ("multi/fsdp_over_pod", True, {"fsdp_over_pod": True}),
    ("multi/ep_over_pod", True, {"ep_over_pod": True}),
    ("multi/both/gather", True, {"fsdp_over_pod": True, "ep_over_pod": True,
                                 "attn_mode": "gather"}),
)
ROLES = (None, "batch", "batch_minus_ep", "fsdp", "tp", "ep")


def _entries(spec) -> list:
    """A spec's entries as JSON: None, a name, or a list of names."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _fake_group(rank: int, world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


def policy_layouts(archs: list[str]) -> dict:
    """The port's side of ``tests/test_torch_sharding.py``, in one process on
    the ``fake`` backend: for each :data:`POLICY_VARIANTS` entry the
    production mesh's shape, the policy, every role's axes, and per arch the
    ``param_specs`` / ``cache_specs`` entries and each parameter's local
    shape on rank 0 (``abstract_params``' meta DTensors); and the offsets
    every rank of a (2, 2, 2) mesh holds of a few tuple-axis specs."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import lm
    from repro_torch.sharding import make_policy
    from repro_torch.train.optimizer import tree_leaves

    out: dict = {"variants": {}, "offsets": {}}
    for name, multi, kw in POLICY_VARIANTS:
        _fake_group(0, 512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        pol = make_policy(mesh, **kw)
        v = {"mesh": {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
                      "size": mesh.size()},
             "policy": {"batch_axes": list(pol.batch_axes), "fsdp_axes": list(pol.fsdp_axes),
                        "tp_axis": pol.tp_axis, "ep_axes": list(pol.ep_axes),
                        "attn_mode": pol.attn_mode, "tp_size": pol.tp_size,
                        "dp_size": pol.dp_size},
             "resolve": [_entries([pol.resolve(r)])[0] for r in ROLES], "archs": {}}
        for arch in archs:
            cfg = ARCHS[arch]
            v["archs"][arch] = {
                "param_specs": [_entries(s) for s in tree_leaves(lm.param_specs(cfg, pol))],
                "cache_specs": [_entries(s) for s in _spec_leaves(lm.cache_specs(cfg, pol))],
                "local_shapes": [_local_shape(t, spec, pol) for t, spec in zip(
                    tree_leaves(lm.abstract_params(cfg)), tree_leaves(lm.param_specs(cfg, pol)))]}
            if all(isinstance(x, list) for x in v["archs"][arch]["local_shapes"]):
                got = [list(t.to_local().shape) for t in tree_leaves(lm.abstract_params(cfg, pol))]
                assert got == v["archs"][arch]["local_shapes"], arch
        out["variants"][name] = v
    for rank in range(8):
        _fake_group(rank, 8)
        mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
        pol = make_policy(mesh, fsdp_over_pod=True, ep_over_pod=True)
        for roles in OFFSET_ROLES:
            spec = pol.spec(*roles)
            shape, offset = compute_local_shape_and_global_offset(
                OFFSET_SHAPE, mesh, pol.placements(spec))
            out["offsets"].setdefault(str(roles), []).append([list(offset), list(shape)])
    return out


def _local_shape(meta, spec, pol):
    """Rank 0's shard shape of a meta leaf under ``spec``, or the error the
    placements raise (a mesh axis named twice)."""
    from torch.distributed.tensor import distribute_tensor

    try:
        placements = pol.placements(spec)
    except ValueError as err:
        return f"error: {err}"
    return list(distribute_tensor(meta, pol.mesh, placements, src_data_rank=None)
                .to_local().shape)


#: (shape, roles) of the tuple-axis layout check on a (2, 2, 2) mesh
OFFSET_SHAPE = (8, 4, 8)
OFFSET_ROLES = (("batch", None, "tp"), ("fsdp", "tp", None), ("ep", "batch_minus_ep", None),
                (None, "batch", None), ("tp", None, "fsdp"))


def _spec_leaves(tree) -> list:
    """The specs of a ``cache_specs`` tree (lists of dicts), in the
    reference's pytree order."""
    if isinstance(tree, list):
        return [s for sub in tree for s in _spec_leaves(sub)]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [tree]


# -- the training launcher -------------------------------------------------------


def launcher_rank(rank: int, n: int, argv: list[str]) -> dict:
    """``python -m repro_torch.launch.train`` as ``torch.distributed.run``
    starts it on rank ``rank`` of ``n`` (``WORLD_SIZE`` / ``LOCAL_RANK`` set,
    the gloo group already made): the lines it printed, its steps and
    losses."""
    import contextlib
    import io
    import os

    from repro_torch.launch import train

    os.environ.update(WORLD_SIZE=str(n), LOCAL_RANK=str(rank), RANK=str(rank))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = train.main(argv)
    return {"lines": out.getvalue().splitlines(), "steps": [h.step for h in hist],
            "losses": [h.loss for h in hist]}


# -- sharded serving ---------------------------------------------------------------


def _leaf_list(tree) -> list:
    """The tensors of a nested cache (lists of dicts), in sorted-key order."""
    if isinstance(tree, list):
        return [t for sub in tree for t in _leaf_list(sub)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaf_list(tree[k])]
    return [tree]


def _whole(t) -> np.ndarray:
    from repro_torch.sharding.policies import is_dtensor

    t = t.full_tensor() if is_dtensor(t) else t
    return (t.float() if t.is_floating_point() else t).numpy().copy()


def sharded_serve_runs(rank: int, n: int, cases: list, tokens: np.ndarray, steps: np.ndarray,
                       prompts: list, max_new: int) -> list:
    """The port's serving route under ``make_policy`` on a ``(n // 2, 2)``
    ``("data", "model")`` mesh of gloo ranks, float32 compute, for each
    ``(arch, flat params, config overrides, make_policy kwargs, engine)``
    case: ``lm.prefill`` of ``tokens`` (room for the decode steps), then one
    ``lm.decode_step`` per column of ``steps``, the logits and caches
    gathered after each (every rank), with the shard shapes of the cache
    leaves; with ``engine``, ``ServeEngine(pol=...)``'s greedy tokens for
    ``prompts`` from ``generate`` (2 slots) and ``generate_continuous``, and
    the logits of every decode step the engine made.  On
    rank 0 also the same calls in one process without a mesh."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import convert
    from repro_torch.configs import ARCHS
    from repro_torch.models import layers, lm
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve import engine as serve_engine
    from repro_torch.sharding import make_policy
    from repro_torch.train.optimizer import tree_map

    layers.COMPUTE_DTYPE = torch.float32
    mesh = init_device_mesh("cpu", (n // 2, 2), mesh_dim_names=("data", "model"))
    out = []
    for arch, flat, overrides, kw, engine in cases:
        cfg = dataclasses.replace(ARCHS[arch].reduced(), **overrides)
        params = tree_map(lambda t: t.float(), convert.lm_params(_unflatten(flat), cfg, "cpu"))

        def serve(pol, p):
            res = {}
            with torch.no_grad():
                logits, caches = lm.prefill(p, {"tokens": torch.from_numpy(tokens)}, cfg,
                                            max_len=tokens.shape[1] + steps.shape[1], pol=pol)
                res["prefill"] = _whole(logits)
                res["prefill_caches"] = [_whole(t) for t in _leaf_list(caches)]
                res["local_shapes"] = [tuple((t.to_local() if pol.mesh is not None else t).shape)
                                       for t in _leaf_list(caches)]
                res["decode"] = []
                for i in range(steps.shape[1]):
                    lg, caches = lm.decode_step(p, caches, {"tokens": torch.from_numpy(
                        steps[:, i:i + 1].copy())}, tokens.shape[1] + i, cfg, pol=pol)
                    res["decode"].append(_whole(lg))
                res["decode_caches"] = [_whole(t) for t in _leaf_list(caches)]
            if engine:
                eng = ServeEngine(cfg, p, ServeConfig(batch_slots=2), pol=pol, device="cpu")
                call, seen = serve_engine._Decode.__call__, []

                def record(self, toks):  # every decode step's logits, whole
                    lg = call(self, toks)
                    seen.append(_whole(lg))
                    return lg

                serve_engine._Decode.__call__ = record
                try:
                    res["generate"] = eng.generate(prompts, max_new)
                    res["continuous"] = eng.generate_continuous(prompts, max_new)
                finally:
                    serve_engine._Decode.__call__ = call
                res["engine_decode"] = seen
            return res

        pol = make_policy(mesh, **kw)
        res = serve(pol, lm.distribute_params(tree_map(lambda t: t.clone(), params), cfg, pol))
        if rank == 0:
            res["plain"] = serve(make_policy(None), params)
        out.append(res)
    return out
