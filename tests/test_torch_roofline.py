"""The port's roofline layer (``repro_torch.roofline``) against the
reference's (``repro.roofline``): the three-term model and the model-FLOP
convention as copies, pinned to the reference's results; the dispatch count
(``roofline/count.py``, the counterpart of ``hlo.py``) held to hand counts
and, on reduced decode and prefill steps, to the reference's HLO analysis
(for a mixture of experts less its one-hot dispatch and combine einsums,
which the port does not do; ``launch/dryrun.moe_onehot_flops``).

Tolerances: the copies exactly; the count of a decode or prefill step within 5 %
of the reference's (XLA counts a reduction's elements as FLOPs, the port's
count, ``torch.utils.flop_counter``'s formulas, counts none).  The sharded
cases run the port on the ``fake`` process-group backend in a subprocess
(a process group in the test worker would outlive the test), the reference
on fake XLA devices (``run_devices``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from repro.roofline.analysis import V5E as JAX_V5E
from repro.roofline.analysis import model_flops as jax_model_flops
from repro.roofline.analysis import roofline as jax_roofline
from repro.roofline.hlo import HloTotals
from repro_torch.roofline import H100, V5E, Totals, model_flops, roofline
from repro_torch.roofline.count import count
from tests.conftest import run_devices

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOTALS = [  # the reference's cases (tests/test_roofline.py:107-115) and cross-pod ones
    dict(flops=1.97e13, hbm_bytes=8.19e11, coll_ring_bytes=5e10),
    dict(flops=3e12, hbm_bytes=2e9, coll_ring_bytes=7e9, cross_pod_bytes=4e9),
    dict(flops=0.0, hbm_bytes=1e6),
]


def _port(code: str, timeout: int = 300) -> dict:
    """Run ``code`` (printing ``JSON`` + a JSON object) in a subprocess on
    the port; its JSON."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, ["src", os.environ.get(
        "PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return json.loads(out.stdout.split("JSON", 1)[1])


@pytest.mark.parametrize("case", range(len(TOTALS)))
def test_roofline_equals_the_references_under_v5e(case):
    kw = TOTALS[case]
    for n in (1, 256):
        mf = 1.97e13 * n * 0.8
        want = jax_roofline(HloTotals(**kw), n_devices=n, model_flops_global=mf, hw=JAX_V5E)
        got = roofline(Totals(**kw), n_devices=n, model_flops_global=mf, hw=V5E)
        assert got.as_dict() == want.as_dict()
    assert V5E == V5E.__class__(**{f: getattr(JAX_V5E, f) for f in JAX_V5E.__dataclass_fields__})


@pytest.mark.parametrize("args", [(1e9, 1000, "train"), (1e9, 1000, "inference"),
                                  (3_821_079_552, 524_288, "train"), (7, 3, "decode")])
def test_model_flops_equals_the_references(args):
    assert model_flops(*args) == jax_model_flops(*args)


def test_h100_terms_by_hand():
    """989 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s a link, 50 GB/s across pods,
    80 GB: each term is its bytes or FLOPs over its rate."""
    assert (H100.peak_flops, H100.hbm_bw, H100.ici_bw, H100.dci_bw, H100.hbm_per_chip) == (
        989e12, 3.35e12, 450e9, 50e9, 80e9)
    t = Totals(flops=9.89e12, hbm_bytes=6.7e10, coll_ring_bytes=2.25e9, cross_pod_bytes=1.5e9)
    rep = roofline(t, n_devices=8, model_flops_global=8 * 4.945e12, hw=H100)
    assert rep.compute_s == pytest.approx(0.01, rel=1e-12)
    assert rep.memory_s == pytest.approx(0.02, rel=1e-12)
    assert rep.collective_s == pytest.approx(0.005, rel=1e-12)
    assert rep.cross_pod_s == pytest.approx(0.03, rel=1e-12)
    assert rep.dominant == "collective" and rep.bound_s == pytest.approx(0.03, rel=1e-12)
    assert rep.useful_ratio == pytest.approx(0.5, rel=1e-12)
    assert rep.roofline_fraction == pytest.approx(0.005 / 0.03, rel=1e-12)


@pytest.mark.parametrize("k", [1, 5, 12])
def test_count_multiplies_a_loop_of_matmuls(k):
    """k products of n×n matrices count k · 2n³ FLOPs (the reference's
    trip-count case, ``tests/test_roofline.py:13-40``: a Python loop here
    is unrolled, so each product is counted where it runs); elementwise ops
    count none, and meta tensors allocate nothing."""
    n = 64
    x = torch.empty((n, n), device="meta")
    ws = [torch.empty((n, n), device="meta") for _ in range(k)]

    def loop(x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    t = count(loop, x, n_devices=1)
    assert t.flops == k * 2 * n**3
    assert t.hbm_bytes == k * 3 * n * n * 4  # each product: two operands and the result
    assert t.coll_counts == {} and t.cross_pod_bytes == 0


def test_nested_loops_multiply():
    n, k_out, k_in = 32, 3, 4
    w = torch.empty((n, n), device="meta")

    def outer(x):
        for _ in range(k_out):
            for _ in range(k_in):
                x = x @ w
        return x

    assert count(outer, torch.empty((n, n), device="meta"), n_devices=1).flops == (
        2 * n**3 * k_out * k_in)


def test_kernels_plain_versions_count_as_kernels():
    """On meta tensors ``kernels/ops.py`` runs a kernel's plain version
    announced to the counter: its products' FLOPs count, its memory is its
    inputs and outputs once (not the score matrix the plain version makes)."""
    from repro_torch.kernels import ops

    b, h, s, d = 2, 4, 256, 64
    q, k, v = (torch.empty((b, h, s, d), dtype=torch.bfloat16, device="meta") for _ in "qkv")
    t = count(lambda: ops.attention(q, k, v), n_devices=1)
    assert t.flops == 2 * (2 * b * h * s * s * d)  # Q Kᵀ and P V over every pair
    assert t.hbm_bytes == 4 * b * h * s * d * 2  # q, k, v in, o out, bf16


SHARDED = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.roofline.count import count, top_collectives

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "data"))
w = distribute_tensor(torch.empty(512, 512, device="meta"), mesh, [Replicate(), Shard(0)],
                      src_data_rank=None)
x = distribute_tensor(torch.empty(16, 512, device="meta"), mesh, [Shard(0), Shard(0)],
                      src_data_rank=None)
t = count(lambda: (x @ w).redistribute(mesh, [Shard(0), Shard(0)]), n_devices=8, pod_size=4)
t2 = count(lambda: x.sum().full_tensor(), n_devices=8, pod_size=4)
t3 = count(lambda: x.redistribute(mesh, [Shard(0), Shard(1)]), n_devices=8, pod_size=4)
print("JSON" + json.dumps({"flops": t.flops, "counts": t.coll_counts, "cross": t.cross_pod_bytes,
                           "rows": t.rows, "top": top_collectives(t), "cross2": t2.cross_pod_bytes,
                           "counts2": t2.coll_counts, "counts3": t3.coll_counts,
                           "operand3": t3.coll_operand_bytes, "ring3": t3.coll_ring_bytes}))
"""


def test_sharded_matmul_per_chip_and_pod_classification():
    """``tests/test_roofline.py:60-87``'s sharded product on a ``(2, 4)``
    ``("pod", "data")`` mesh with pods of 4: rank 0's FLOPs are its share,
    2·2·512·512; the activation moves inside a pod only (DTensor moves x by
    an all-to-all where XLA gathers w; both stay in the pod); a reduction
    over both axes crosses the pod boundary."""
    out = _port(SHARDED)
    assert out["flops"] == 2 * 2 * 512 * 512
    moved = sum(out["counts"].get(k, 0) for k in ("all-gather", "all-to-all", "reduce-scatter"))
    assert moved >= 1, out["counts"]
    assert out["cross"] == 0.0
    assert all(r["group"] == 4 and not r["cross_pod"] for r in out["rows"])
    assert out["top"] and out["top"][0]["mult"] >= 1
    assert out["counts2"].get("all-reduce", 0) >= 1 and out["cross2"] > 0


def test_dtensor_alltoall_is_counted_as_an_alltoall():
    """DTensor's ``Shard(0) → Shard(1)`` move over ``data`` (run as an
    all-gather on a CPU mesh, told apart by the frame of its
    ``shard_dim_alltoall``) counts as one all-to-all of rank 0's result,
    ``[8, 128]`` float32, with the ring's ``(g - 1) / g`` of it: a torch
    that renamed that function would count an all-gather here."""
    out = _port(SHARDED)
    assert out["counts3"] == {"all-to-all": 1}
    assert out["operand3"] == 8 * 128 * 4 and out["ring3"] == out["operand3"] * 3 / 4


STEP_REF = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.compat import make_mesh
from repro.configs import ARCHS
from repro.models import lm
from repro.roofline.hlo import analyze
from repro.sharding.policies import make_policy

mesh = make_mesh((2, 4), ("data", "model"))
pol = make_policy(mesh)
cfg = dataclasses.replace(ARCHS[{arch!r}].reduced(), **{overrides!r})
sds = lambda shape, dtype, spec: jax.ShapeDtypeStruct(shape, dtype,
                                                      sharding=NamedSharding(mesh, spec))
params = jax.tree.map(lambda pd, sp: sds(pd.shape, pd.dtype, sp), lm.param_defs(cfg),
                      lm.param_specs(cfg, pol), is_leaf=lambda x: isinstance(x, lm.PDef))
if {kind!r} == "decode":
    shapes = jax.eval_shape(lambda: lm.init_cache(cfg, {batch}, {seq}, pol))
    cache = jax.tree.map(lambda s, sp: sds(s.shape, s.dtype, sp), shapes,
                         lm.cache_specs(cfg, pol))
    batch = {{"tokens": sds(({batch}, 1), jnp.int32, pol.spec("batch", None))}}
    pos = sds((), jnp.int32, pol.spec())
    fn = lambda p, c, b, t: lm.decode_step(p, c, b, t, cfg, pol)
    hlo = jax.jit(fn).lower(params, cache, batch, pos).compile().as_text()
else:
    batch = {{"tokens": sds(({batch}, {seq}), jnp.int32, pol.spec("batch", None))}}
    fn = lambda p, b: lm.prefill(p, b, cfg, pol, max_len={seq})
    hlo = jax.jit(fn).lower(params, batch).compile().as_text()
print("FLOPS", analyze(hlo, n_devices=8).flops)
"""

STEP_PORT = """
import dataclasses, json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCHS
from repro_torch.launch.dryrun import moe_onehot_flops
from repro_torch.models import lm
from repro_torch.roofline.count import count
from repro_torch.sharding import make_policy

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
pol = make_policy(mesh)
cfg = dataclasses.replace(ARCHS[{arch!r}].reduced(), **{overrides!r})
params = lm.abstract_params(cfg, pol)
with torch.no_grad():
    if {kind!r} == "decode":
        cache = lm.init_cache(cfg, {batch}, {seq}, pol=pol, device="meta")
        batch = {{"tokens": torch.empty(({batch}, 1), dtype=torch.int32, device="meta")}}
        t = count(lm.decode_step, params, cache, batch, {seq} - 1, cfg, pol=pol, n_devices=8)
    else:
        batch = {{"tokens": torch.empty(({batch}, {seq}), dtype=torch.int32, device="meta")}}
        t = count(lm.prefill, params, batch, cfg, max_len={seq}, pol=pol, n_devices=8)
onehot = moe_onehot_flops(cfg, {batch}, 1 if {kind!r} == "decode" else {seq}, pol)
print("JSON" + json.dumps({{"flops": t.flops, "onehot": onehot}}))
"""


def _step_flops(arch: str, kind: str, batch: int, seq: int, overrides=None) -> tuple:
    """(the reference's per-chip FLOPs, the port's count, the reference's
    one-hot MoE einsums' FLOPs) of reduced ``arch``'s decode step (a cache
    of ``seq`` slots) or prefill (``seq`` tokens) on a ``(2, 4)`` mesh."""
    kw = dict(arch=arch, kind=kind, batch=batch, seq=seq, overrides=overrides or {})
    ref = float(run_devices(STEP_REF.format(**kw), 8).split("FLOPS", 1)[1])
    port = _port(STEP_PORT.format(**kw))
    return ref, port["flops"], port["onehot"]


def test_dense_decode_flops_are_the_references():
    """Reduced phi4's decode step on a ``(2, 4)`` mesh (batch 8, a cache of
    256 slots): the port's per-chip FLOPs within 5 % of the reference's
    HLO count on 8 fake XLA devices."""
    ref, port, onehot = _step_flops("phi4-mini-3.8b", "decode", 8, 256)
    assert onehot == 0.0
    assert ref > 0 and abs(port - ref) <= 0.05 * ref, (port, ref)


@pytest.mark.parametrize("kind,overrides", [
    ("decode", {}),  # capacity 1: the einsums are small
    ("prefill", {}),  # 8 experts over model of 4: expert parallelism
    ("prefill", {"n_experts": 6}),  # 6 experts, which 4 does not divide: the TP mode
])
def test_moe_flops_are_the_references_less_its_onehot_einsums(kind, overrides):
    """Reduced qwen3-moe (batch 8; a cache of 256 slots, or 256 prompt
    tokens): the port dispatches by index, the reference by one-hot
    einsums ``[B, S, E, C]``; the port's per-chip FLOPs plus
    ``dryrun.moe_onehot_flops`` are within 5 % of the reference's HLO
    count, and at prefill the port's alone are not (the einsums are a
    third of the reference's)."""
    ref, port, onehot = _step_flops("qwen3-moe-30b-a3b", kind, 8, 256, overrides)
    assert ref > 0 and abs(port + onehot - ref) <= 0.05 * ref, (port, onehot, ref)
    if kind == "prefill":
        assert abs(port - ref) > 0.05 * ref, (port, ref)
