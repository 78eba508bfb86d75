"""The port's train step sharded over many ranks (``repro_torch.sharding``,
DTensor on a ``DeviceMesh``) against the reference's sharded step and the
port's one-process step, on the CPU.

Four families, reduced: phi4-mini-3.8b (attention), qwen3-moe-30b-a3b
(expert parallelism on: 8 experts over ``model`` of size 2), mamba2-1.3b
and recurrentgemma-9b; batch 4 × 64 in 2 microbatches, one AdamW step
(warmup 2), from the reference's ``init_params`` (key 0) carried across by
``convert.lm_params``, under float32 compute (every leaf float32) and bf16
compute (the parameters' own dtypes).  The port runs on 4 gloo ranks on a
``(2, 2)`` ``("data", "model")`` mesh under ``make_policy``
(``tests/_torch_dist.py:sharded_train_steps``); the reference's ``jax.jit``
step (and, under bf16, its gradients) runs under its ``make_policy`` on 4
fake host devices in a subprocess (``run_devices``), once for the module,
beside the ranks.  One more case runs phi4 under float32 with
``attn_mode="gather"``, held to the one-process step.

Tolerances (``tests/test_torch_train.py``'s).  Float32 compute: loss and
``grad_norm`` within 1e-5 relative; every updated leaf at rtol 1e-5, atol
1e-7 where the one-process gradient is above 1e-4 of its leaf's largest
(Adam's first step is about lr·sign(g): an entry at the noise floor may
move the other way).  Bf16 compute: loss and ``grad_norm`` within 2e-2
relative and each gradient leaf's cosine with the reference's at least
0.99; there Adam's sign-like first step turns a rounding-level gradient
difference into a whole 2·lr flip of an entry (the port's one-process
step already flips up to 4 % of a MoE leaf's entries against the
reference), so each updated leaf is held to the one-process step's: its
change from the initial value within 2e-2 of that step's change, in
relative L1 norm.
"""
from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.models import lm as jlm
from repro_torch.configs import ARCHS
from repro_torch.models import lm
from repro_torch.sharding import make_policy
from repro_torch.train.optimizer import tree_leaves
from tests._torch_dist import sharded_train_steps, spawn
from tests.conftest import run_devices

FAMILIES = ["phi4-mini-3.8b", "qwen3-moe-30b-a3b", "mamba2-1.3b", "recurrentgemma-9b"]
DTYPES = ["float32", "bfloat16"]
CASES = [(a, d) for a in FAMILIES for d in DTYPES]
SEQ, BATCH = 64, 4
RTOL = {"float32": 1e-5, "bfloat16": 2e-2}

REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro import data as jdata
from repro.compat import make_mesh
from repro.configs import ARCHS
from repro.models import layers as JL, lm
from repro.sharding.policies import make_policy
from repro.train import optimizer as jopt, train_step as jts

mesh = make_mesh((2, 2), ("data", "model"))
pol = make_policy(mesh)
out = {{}}
for arch in {archs!r}:
    cfg = ARCHS[arch].reduced()
    for dtype in {dtypes!r}:
        JL.COMPUTE_DTYPE = getattr(jnp, dtype)
        params = lm.init_params(cfg, jax.random.PRNGKey(0))
        if dtype == "float32":
            params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        params = jax.tree.map(lambda a, sp: jax.device_put(a, NamedSharding(mesh, sp)),
                              params, lm.param_specs(cfg, pol))
        batch = {{k: jnp.asarray(v) for k, v in jdata.SyntheticLM(
            cfg, jdata.DataConfig(seq_len={seq}, global_batch={batch}))(0).items()}}
        key = arch + "|" + dtype
        if dtype == "bfloat16":
            _, grads = jax.jit(jts.make_grad_fn(cfg, pol, 2))(params, batch)
            for i, leaf in enumerate(jax.tree.leaves(grads)):
                out[key + "|grads|%d" % i] = np.asarray(leaf, np.float32)
        step = jax.jit(jts.make_train_step(cfg, pol, jts.TrainStepConfig(
            n_microbatches=2, adamw=jopt.AdamWConfig(warmup_steps=2, total_steps=50))))
        loss, new, opt, metrics = step(params, jopt.init_opt_state(params), batch)
        out[key + "|loss"] = np.float64(loss)
        out[key + "|grad_norm"] = np.float64(metrics["grad_norm"])
        for i, leaf in enumerate(jax.tree.leaves(new)):
            out[key + "|params|%d" % i] = np.asarray(leaf, np.float32)
        for i, leaf in enumerate(jax.tree.leaves(opt["master"])):
            out[key + "|master|%d" % i] = np.asarray(leaf, np.float32)
np.savez({dst!r}, **out)
print("OK")
"""


def _flat(tree, prefix: str = "") -> dict:
    """Leaves keyed by path, float32 numpy, in sorted-key order."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], prefix + key + "/").items()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _leaves(z: dict, key: str) -> list:
    n = sum(1 for k in z if k.startswith(key + "|"))
    return [z[f"{key}|{i}"] for i in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(arch, dtype): (the port's results by rank, the reference's, the
    initial leaves)}"""
    tmp = tmp_path_factory.mktemp("sharded_train")
    dst = str(tmp / "reference.npz")
    cases = []
    for arch in FAMILIES:
        flat = _flat(jlm.init_params(ARCHS[arch].reduced(), jax.random.PRNGKey(0)))
        cases += [(arch, dtype, flat) for dtype in DTYPES]
    # attention's other reshard mode, held to the one-process step
    cases.append((FAMILIES[0], "float32", cases[0][2], {"attn_mode": "gather"}))
    code = REFERENCE.format(archs=FAMILIES, dtypes=DTYPES, seq=SEQ, batch=BATCH, dst=dst)
    with ThreadPoolExecutor(1) as pool:  # the reference beside the ranks
        ref = pool.submit(run_devices, code, 4, 600)
        port = spawn(sharded_train_steps, 4, tmp / "ranks", cases, SEQ, BATCH, timeout=600)
        assert "OK" in ref.result()
    z = dict(np.load(dst))
    out = {"gather": [r[-1] for r in port]}
    for i, (arch, dtype, flat, *_) in enumerate(cases[:-1]):
        key = f"{arch}|{dtype}"
        out[arch, dtype] = ([r[i] for r in port], {
            "loss": float(z[key + "|loss"]), "grad_norm": float(z[key + "|grad_norm"]),
            "params": _leaves(z, key + "|params"), "master": _leaves(z, key + "|master"),
            "grads": _leaves(z, key + "|grads")}, list(flat.values()))
    return out


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def _masked_close(got, want, plain_grads):
    """Float32: every leaf where the one-process gradient is above 1e-4 of
    its leaf's largest, at rtol 1e-5, atol 1e-7."""
    for i, (t, j, g) in enumerate(zip(got, want, plain_grads)):
        g = np.abs(g)
        keep = g > 1e-4 * g.max()
        np.testing.assert_allclose(t[keep], j[keep], rtol=1e-5, atol=1e-7, err_msg=f"leaf {i}")


@pytest.mark.parametrize("arch,dtype", CASES)
def test_sharded_step_equals_the_reference_sharded_step(runs, arch, dtype):
    ranks, ref, init = runs[arch, dtype]
    got, rtol = ranks[0], RTOL[dtype]
    assert all(r["loss"] == got["loss"] for r in ranks)  # one replicated value
    assert abs(got["loss"] - ref["loss"]) <= rtol * abs(ref["loss"])
    assert abs(got["grad_norm"] - ref["grad_norm"]) <= rtol * ref["grad_norm"]
    assert len(got["master"]) == len(ref["master"]) == len(init)
    for t, j in zip(got["params"], ref["params"]):
        assert t.shape == j.shape
    if dtype == "float32":
        _masked_close(got["params"], ref["params"], got["plain_grads"])
    else:
        assert len(got["grads"]) == len(ref["grads"]) == len(init)
        for i, (t, j) in enumerate(zip(got["grads"], ref["grads"])):
            assert _cos(t, j) >= 0.99, f"leaf {i}: cosine {_cos(t, j)}"


@pytest.mark.parametrize("arch,dtype", CASES)
def test_sharded_step_equals_the_one_process_step(runs, arch, dtype):
    ranks, _, init = runs[arch, dtype]
    got, rtol = ranks[0], RTOL[dtype]
    assert abs(got["loss"] - got["plain_loss"]) <= rtol * abs(got["plain_loss"])
    assert abs(got["grad_norm"] - got["plain_grad_norm"]) <= rtol * got["plain_grad_norm"]
    if dtype == "float32":
        _masked_close(got["params"], got["plain_params"], got["plain_grads"])
        return
    for i, (g, t) in enumerate(zip(got["grads"], got["plain_grads"])):
        assert _cos(g, t) >= 0.99, f"leaf {i}: cosine {_cos(g, t)}"
    for i, (m, pm, p0) in enumerate(zip(got["master"], got["plain_master"], init)):
        want = pm - p0
        rel = np.abs((m - p0) - want).sum() / np.abs(want).sum()
        assert rel <= 2e-2, f"leaf {i}: relative L1 {rel}"


@pytest.mark.parametrize("arch", FAMILIES)
def test_leaves_are_partial_on_every_rank(runs, arch):
    """Every leaf's local shard is its spec's share of the leaf on every rank
    (each mesh axis a dim names halves it): the embedding holds half its
    rows and an FSDP leaf half its rows; and the step all-gathered and
    reduced across ranks."""
    ranks, _, _ = runs[arch, "bfloat16"]
    pol = make_policy(SimpleNamespace(mesh_dim_names=("data", "model")))
    specs = tree_leaves(lm.param_specs(ARCHS[arch].reduced(), pol))
    for rank, res in enumerate(ranks):
        assert len(res["local_shapes"]) == len(specs)
        for shape, local, spec in zip(res["shapes"], res["local_shapes"], specs):
            want = tuple(math.ceil(n / 2 ** len(spec.axes_of(d))) for d, n in enumerate(shape))
            assert local == want, (rank, shape, spec)
        embed = 0  # embed/tok sorts first: ("tp", None)
        assert res["local_shapes"][embed][0] * 2 == res["shapes"][embed][0]
        fsdp = [i for i, sp in enumerate(specs) if len(sp) == 3 and "data" in sp.axes_of(1)]
        assert fsdp and all(res["local_shapes"][i][1] * 2 == res["shapes"][i][1] for i in fsdp)
        comm = res["comm"]
        assert any("all_gather" in k and v for k, v in comm.items()), comm
        assert any(("reduce_scatter" in k or "all_reduce" in k) and v for k, v in comm.items())


def test_gather_attention_mode_equals_the_one_process_step(runs):
    """``attn_mode="gather"`` (q sequence-sharded straight from the
    projection, no activation all-to-all) computes the same step: phi4,
    float32."""
    got = runs["gather"][0]
    assert abs(got["loss"] - got["plain_loss"]) <= 1e-5 * abs(got["plain_loss"])
    assert abs(got["grad_norm"] - got["plain_grad_norm"]) <= 1e-5 * got["plain_grad_norm"]
    _masked_close(got["params"], got["plain_params"], got["plain_grads"])
