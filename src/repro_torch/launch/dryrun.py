"""Multi-pod dry-run: count one step of every (arch × shape × mesh) cell on
the production mesh and price it on the H100.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell on 512 fake host devices and reads the HLO.  Here nothing runs on a
device, by nature: the cell's parameters, optimizer state, cache and inputs
are meta tensors (shape and dtype, no data), laid out as DTensors on
``make_production_mesh(multi_pod, device_type="cpu")`` over the ``fake``
process-group backend (one process plays rank 0 of 256 or 512), and
:func:`repro_torch.roofline.count` runs the step once — ``make_train_step``,
``lm.prefill`` or ``lm.decode_step`` — counting rank 0's FLOPs, HBM bytes
and collectives by dispatch.  The kernels' plain versions stand in for the
kernels on meta tensors (``kernels/ops.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all              # full sweep
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh multi
  ... --fsdp-over-pod / --ep-over-pod / --microbatches N   # the reference's knobs

Each cell appends a JSON record to ``--out`` (default
``benchmarks/results/dryrun_torch.jsonl``); completed (arch, shape, mesh,
tag) cells are skipped on re-run, so the sweep is resumable; the exit code
is 1 when any cell failed.  The record has the reference's keys:

* ``hlo``: the per-chip counts under the reference's name, so records of
  the two packages line up; here they come from dispatch counting, not HLO.
* ``memory``: ``argument_size_in_bytes``, the exact sum of rank 0's local
  bytes of the parameters (and, for train, the optimizer state), the cache
  and the inputs (the decode position, a Python int here, is none);
  ``output_size_in_bytes``, the local bytes of what the step returns;
  ``temp_size_in_bytes``, an estimate (``temp_is_estimate``): the count's
  peak of live intermediate bytes; ``fits_80g`` against the H100's 80 GB.
* ``roofline`` priced with :data:`~repro_torch.roofline.H100`, ``netsim``,
  ``top_collectives``, ``tokens_per_step``.
* ``xla_cost`` (XLA's own cost analysis) has no counterpart and is left out.
* ``moe_onehot_flops_per_chip`` (mixtures of experts only): the FLOPs of
  the reference's one-hot dispatch and combine einsums
  (:func:`moe_onehot_flops`), which the port's index dispatch does not do,
  so that ``hlo.flops_per_chip`` plus it is the reference's count; ``null``
  for a train cell, whose backward and recomputation are not reckoned.

The meshes are the reference's (16 × 16 and 2 × 16 × 16, pods of 256), so
that the records compare; an H100 NVLink domain is 8 cards.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import POD_SIZE, make_production_mesh
from repro_torch.models import lm
from repro_torch.roofline.analysis import H100, model_flops, roofline
from repro_torch.roofline.count import count, top_collectives
from repro_torch.sharding.policies import is_dtensor, make_policy
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import TrainStepConfig, make_train_step

__all__ = ["TRAIN_MICROBATCHES", "input_specs", "abstract_state", "abstract_cache",
           "cell_arguments", "argument_bytes", "moe_onehot_flops", "run_cell", "main"]

# per-arch microbatch counts for train_4k (the reference's)
TRAIN_MICROBATCHES = {
    "mixtral-8x22b": 8,
    "yi-34b": 8,
    "qwen2.5-14b": 8,
    "qwen3-moe-30b-a3b": 8,
    "recurrentgemma-9b": 8,
    "phi4-mini-3.8b": 4,
    "deepseek-7b": 4,
    "llava-next-mistral-7b": 4,
    "musicgen-large": 4,
    "mamba2-1.3b": 4,
}


def _fake_world(world: int) -> None:
    """A ``fake`` process group of ``world`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Meta stand-ins (global shapes) for the data inputs of one cell; the
    step lays them out over the batch axes (``lm.distribute_batch``)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        if cfg.modality == "audio":
            return {"tokens": _meta((b, 1, cfg.n_codebooks), i32)}
        return {"tokens": _meta((b, 1), i32)}
    if cfg.modality == "audio":
        return {"tokens": _meta((b, s, cfg.n_codebooks), i32),
                "labels": _meta((b, s, cfg.n_codebooks), i32)}
    if cfg.modality == "vlm":
        st = s - cfg.vision_tokens
        return {"tokens": _meta((b, st), i32), "labels": _meta((b, st), i32),
                "vision_embed": _meta((b, cfg.vision_tokens, cfg.d_model), torch.float32)}
    out = {"tokens": _meta((b, s), i32)}
    if shape.kind == "train":
        out["labels"] = _meta((b, s), i32)
    return out


def abstract_state(cfg: ArchConfig, pol):
    """(params, opt_state) as meta DTensors at their specs' placements."""
    params = lm.abstract_params(cfg, pol)
    return params, init_opt_state(params)


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int, pol):
    return lm.init_cache(cfg, batch, max_len, pol=pol, device="meta")


def _local_bytes(tree) -> int:
    """Rank 0's bytes of the tensors in nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    x = tree.to_local() if is_dtensor(tree) else tree
    return x.numel() * x.element_size()


def cell_arguments(arch: str, shape_name: str, multi_pod: bool, *, fsdp_over_pod: bool = False,
                   ep_over_pod: bool = False, attn_mode: str = "a2a",
                   decode_replicated_weights: bool = True) -> dict:
    """The cell's policy and abstract arguments, as the reference's
    ``run_cell`` builds them (the fake world made first): ``pol``,
    ``params``, ``opt`` (train), ``cache`` (decode), ``batch`` and, for
    decode, ``decode_weights``."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    _fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    pol = make_policy(mesh, fsdp_over_pod=fsdp_over_pod, ep_over_pod=ep_over_pod,
                      attn_mode=attn_mode)
    if shape.global_batch < pol.dp_size:
        # e.g. long_500k (B=1): batch cannot shard over the dp axes —
        # the cache/state shards over tp only; data parallelism idles
        pol = dataclasses.replace(pol, batch_axes=())
    out = {"pol": pol, "batch": input_specs(cfg, shape)}
    if shape.kind == "decode":
        # FSDP at decode streams the whole model through the interconnect
        # every token: replicate weights over the dp axes when the bf16
        # params fit beside the cache (the reference's rule)
        fits = cfg.param_count() * 2 / max(pol.tp_size, 1) < 8e9
        if decode_replicated_weights and fits:
            pol = dataclasses.replace(pol, fsdp_axes=())
            out["decode_weights"] = "replicated_over_dp"
        else:
            out["decode_weights"] = "fsdp"
        out["pol"] = pol
        out["cache"] = abstract_cache(cfg, shape.global_batch, shape.seq_len, pol)
        out["params"] = lm.abstract_params(cfg, pol)
    elif shape.kind == "train":
        out["params"], out["opt"] = abstract_state(cfg, pol)
    else:
        out["params"] = lm.abstract_params(cfg, pol)
    return out


def moe_onehot_flops(cfg: ArchConfig, batch: int, seq: int, pol) -> float:
    """Rank 0's FLOPs in the reference's one-hot MoE einsums for a prefill
    (``seq`` tokens a row) or decode step (``seq`` 1) of ``batch`` rows, which
    the port does not do: it dispatches and combines by index
    (``layers.moe_block``), so its count plus this is the reference's
    ``hlo.flops``.  Per MoE layer and dispatch group (rows of at most 4,096
    tokens, as there) of ``S`` tokens, ``E`` experts, top ``k``, capacity
    ``C`` and width ``D`` (``repro/models/layers.py:351-393``): each slot's
    place in its expert ``2·S·k·E`` (``bske,bske->bsk``), the dispatch and
    combine masks ``2 · 2·S·E·C·k`` (``bske,bskc->bsec``), the tokens into
    the expert buffers and the outputs back ``2 · 2·S·E·C·D``
    (``bsec,bsd->ebcd``, ``bsec,ebcd->bsd``).  Each is split over the
    batch axes, and under expert parallelism also over the experts'."""
    if not cfg.n_experts:
        return 0.0
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    if seq > 4096 and seq % 4096 == 0:
        batch, seq = batch * (seq // 4096), 4096
    cap = int(seq * k * 1.25 / e) + 1
    per_row = 2 * seq * k * e + 4 * seq * e * cap * k + 4 * seq * e * cap * d
    ep = pol.tp_size > 1 and e % pol.tp_size == 0
    roles = ("batch_minus_ep", "ep") if ep else ("batch",)
    shards = 1
    for name in (a for r in roles for a in pol.resolve(r) or ()):
        shards *= pol.mesh[name].size()
    return cfg.n_layers * batch * per_row / shards


def argument_bytes(args: dict) -> int:
    """Rank 0's local bytes of a cell's arguments: params, optimizer state,
    cache and inputs (each input split over the batch axes on dim 0)."""
    pol = args["pol"]
    total = sum(_local_bytes(args[k]) for k in ("params", "opt", "cache") if k in args)
    for x in args["batch"].values():
        local, _ = pol.local_box(tuple(x.shape), "batch", *(None,) * (x.ndim - 1))
        total += int(torch.Size(local).numel()) * x.element_size()
    return total


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    *,
    fsdp_over_pod: bool = False,
    ep_over_pod: bool = False,
    microbatches: int | None = None,
    attn_mode: str = "a2a",
    decode_replicated_weights: bool = True,
    tag: str = "baseline",
    verbose: bool = True,
) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag, "status": "ok"}
    if shape.kind == "decode" and shape.name == "long_500k" and not cfg.supports_long_context:
        rec["status"] = "skipped"
        rec["reason"] = "full-attention arch: unbounded KV at 500k (DESIGN.md §5)"
        return rec
    t0 = time.time()
    try:
        args = cell_arguments(arch, shape_name, multi_pod, fsdp_over_pod=fsdp_over_pod,
                              ep_over_pod=ep_over_pod, attn_mode=attn_mode,
                              decode_replicated_weights=decode_replicated_weights)
        pol, params, batch = args["pol"], args["params"], args["batch"]
        n_dev = pol.mesh.size()
        out: dict = {}
        if shape.kind == "train":
            n_mb = microbatches or TRAIN_MICROBATCHES.get(arch, 4)
            # multi-pod doubles the dp width: the per-microbatch batch
            # must still divide (pod × data) = 32 shards
            if multi_pod:
                n_mb = min(n_mb, shape.global_batch // 32)
            ts = TrainStepConfig(n_microbatches=n_mb, adamw=AdamWConfig())
            step = make_train_step(cfg, ts, pol)
            rec["microbatches"] = n_mb

            def run():
                out["out"] = step(params, args["opt"], batch)
            tokens = shape.global_batch * shape.seq_len
        elif shape.kind == "prefill":
            def run():
                with torch.no_grad():
                    out["out"] = lm.prefill(params, batch, cfg, pol=pol)
            tokens = shape.global_batch * shape.seq_len
        else:  # decode
            rec["decode_weights"] = args["decode_weights"]

            def run():
                with torch.no_grad():
                    out["out"] = lm.decode_step(params, args["cache"], batch, shape.seq_len - 1,
                                                cfg, pol=pol)
            tokens = shape.global_batch
        totals = count(run, n_devices=n_dev, pod_size=POD_SIZE)
        rec["count_s"] = round(time.time() - t0, 1)

        arg_b = argument_bytes(args)
        rec["memory"] = {
            "argument_size_in_bytes": arg_b,
            "output_size_in_bytes": _local_bytes(out["out"]),
            "temp_size_in_bytes": int(totals.peak_bytes),
            "temp_is_estimate": True,
        }
        total = arg_b + totals.peak_bytes
        rec["memory"]["total_per_device_gib"] = round(total / 2**30, 3)
        rec["memory"]["fits_80g"] = bool(total < H100.hbm_per_chip)

        rec["top_collectives"] = [
            {k2: (round(v2) if isinstance(v2, float) else v2) for k2, v2 in r.items()}
            for r in top_collectives(totals, k=10)
        ]
        mf = model_flops(
            cfg.active_param_count(),
            tokens,
            shape.kind if shape.kind == "train" else "inference",
        )
        rep = roofline(totals, n_devices=n_dev, model_flops_global=mf, hw=H100)
        rec["hlo"] = {
            "flops_per_chip": totals.flops,
            "hbm_bytes_per_chip": totals.hbm_bytes,
            "coll_operand_bytes": totals.coll_operand_bytes,
            "coll_ring_bytes": totals.coll_ring_bytes,
            "cross_pod_bytes": totals.cross_pod_bytes,
            "coll_counts": totals.coll_counts,
            "coll_bytes_by_kind": {
                k: round(v) for k, v in totals.coll_bytes_by_kind.items()
            },
        }
        if cfg.n_experts:  # the reference's one-hot einsums, which the port does not do
            rec["moe_onehot_flops_per_chip"] = None if shape.kind == "train" else (
                moe_onehot_flops(cfg, shape.global_batch,
                                 1 if shape.kind == "decode" else shape.seq_len, pol))
        rec["roofline"] = rep.as_dict()
        rec["hw"] = H100.name
        rec["tokens_per_step"] = tokens
        rec["netsim"] = _netsim(totals, n_dev)

        if verbose:
            ns = rec["netsim"].get("critical_path_ms", "?")
            print(
                f"[{arch} × {shape_name} × {mesh_name} × {tag}] "
                f"count {rec['count_s']:.0f}s | "
                f"terms c/m/x = {rep.compute_s*1e3:.1f}/{rep.memory_s*1e3:.1f}/"
                f"{rep.collective_s*1e3:.1f} ms | dominant={rep.dominant} | "
                f"roofline {rep.roofline_fraction:.2%} | "
                f"mem {rec['memory'].get('total_per_device_gib', '?')} GiB | "
                f"netsim {ns} ms",
                flush=True,
            )
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] FAILED: {rec['error']}", flush=True)
    return rec


def _netsim(totals, n_dev: int) -> dict:
    """The reference's wall-clock preview: the per-chip collective byte
    totals replayed over a two-tier pod fabric (intra bytes on the pod
    ring, cross-pod bytes to each chip's counterpart in the next pod)."""
    try:
        from repro_torch import netsim

        cross = float(totals.cross_pod_bytes)
        intra = max(float(totals.coll_ring_bytes) - cross, 0.0)
        # pod extent capped at the mesh size so the ring neighbor
        # wraps inside the device range on sub-pod (test) meshes
        pod = min(POD_SIZE, n_dev)
        multi = n_dev > pod and n_dev % pod == 0
        topo = netsim.two_tier(n_dev, pod) if multi else netsim.single_switch(n_dev)
        intra_msgs = [
            netsim.Message(d, (d // pod) * pod + (d + 1) % pod, int(intra), tag="intra")
            for d in range(n_dev)
            if intra > 0 and pod > 1
        ]
        cross_msgs = [
            netsim.Message(d, (d + pod) % n_dev, int(cross), tag="cross")
            for d in range(n_dev)
            if multi and cross > 0
        ]
        sim = netsim.simulate([intra_msgs, cross_msgs], topo)
        sim.assert_conserved()
        return {
            "topology": topo.name,
            "critical_path_ms": round(sim.t_total * 1e3, 3),
            "cross_pod_bytes_per_chip": round(cross),
            "intra_bytes_per_chip": round(intra),
        }
    except Exception as e:  # preview must never fail the cell
        return {"error": str(e)}


def _done_keys(path: str) -> set:
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") in ("ok", "skipped"):
                        done.add((r["arch"], r["shape"], r["mesh"], r.get("tag", "baseline")))
                except json.JSONDecodeError:
                    continue
    return done


def main(argv: list[str] | None = None) -> None:
    from repro_torch.configs import ARCHS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="benchmarks/results/dryrun_torch.jsonl")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--fsdp-over-pod", action="store_true")
    ap.add_argument("--ep-over-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--attn-mode", choices=["a2a", "gather"], default="a2a")
    ap.add_argument("--fsdp-decode", action="store_true", help="keep FSDP at decode (baseline)")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set() if args.force else _done_keys(args.out)

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                key = (arch, shape, mesh_name, args.tag)
                if key in done:
                    continue
                rec = run_cell(
                    arch,
                    shape,
                    mp,
                    fsdp_over_pod=args.fsdp_over_pod,
                    ep_over_pod=args.ep_over_pod,
                    microbatches=args.microbatches,
                    attn_mode=args.attn_mode,
                    decode_replicated_weights=not args.fsdp_decode,
                    tag=args.tag,
                )
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skipped"
                n_err += rec["status"] == "error"
    print(f"dry-run sweep: {n_ok} ok, {n_skip} skipped, {n_err} errors", flush=True)
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
