"""The port's sharding layer (``repro_torch.sharding.policies``,
``repro_torch.launch.mesh``, ``lm.param_specs`` / ``cache_specs`` /
``abstract_params``) against the reference's.

The reference runs once, in a subprocess on 512 fake host devices
(``run_devices``): both production meshes, every policy variant of
``tests/_torch_dist.py:POLICY_VARIANTS`` (``fsdp_over_pod``,
``ep_over_pod``, ``attn_mode``), every config of the zoo at full size.
The port runs once, in a subprocess on the ``fake`` process-group backend
(``tests/_torch_dist.py:policy_layouts``: a 16 × 16 or 2 × 16 × 16
``DeviceMesh`` in one process, no JAX).  Specs and resolved roles must be
equal entry by entry; each parameter's shard on rank 0 must have JAX's
``NamedSharding.shard_shape``, and every uneven leaf, where DTensor cuts as
``torch.chunk`` does and JAX pads, is listed (none is, at the production
meshes); a spec the reference refuses (a mesh axis named twice) the port
refuses too.  On a (2, 2, 2) mesh, where a tuple entry such as
``("pod", "data")`` splits one dim over two axes, every rank holds the
offsets and shape JAX's ``devices_indices_map`` gives its device.
"""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.sharding import ShardingPolicy, make_policy
from repro_torch.sharding.policies import PartitionSpec, replicated_constants
from tests._torch_dist import OFFSET_ROLES, OFFSET_SHAPE, POLICY_VARIANTS, ROLES
from tests.conftest import run_devices

ARCH_NAMES = sorted(ARCHS)

REFERENCE = """
import json, numpy as np, jax
from jax.sharding import Mesh, NamedSharding
from repro.configs import ARCHS
from repro.models import lm
from repro.sharding.policies import make_policy

def entries(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

devs = np.array(jax.devices())
meshes = {{False: Mesh(devs[:256].reshape(16, 16), ("data", "model")),
          True: Mesh(devs.reshape(2, 16, 16), ("pod", "data", "model"))}}
out = {{"variants": {{}}, "offsets": {{}}}}
for name, multi, kw in {variants!r}:
    mesh = meshes[multi]
    pol = make_policy(mesh, **kw)
    v = {{"mesh": {{"shape": list(mesh.devices.shape), "names": list(mesh.axis_names),
                  "size": int(mesh.devices.size)}},
         "policy": {{"batch_axes": list(pol.batch_axes), "fsdp_axes": list(pol.fsdp_axes),
                    "tp_axis": pol.tp_axis, "ep_axes": list(pol.ep_axes),
                    "attn_mode": pol.attn_mode, "tp_size": pol.tp_size, "dp_size": pol.dp_size}},
         "resolve": [entries([pol.resolve(r)])[0] for r in {roles!r}], "archs": {{}}}}
    for arch in {archs!r}:
        cfg = ARCHS[arch]
        pspecs = jax.tree.leaves(lm.param_specs(cfg, pol))
        shapes = [pd.shape for pd in jax.tree.leaves(
            lm.param_defs(cfg), is_leaf=lambda x: isinstance(x, lm.PDef))]
        local = []
        for spec, shape in zip(pspecs, shapes):
            try:
                local.append(list(NamedSharding(mesh, spec).shard_shape(shape)))
            except Exception as err:
                local.append("error: " + type(err).__name__ + ": " + str(err)[:200])
        v["archs"][arch] = {{"param_specs": [entries(s) for s in pspecs],
                            "cache_specs": [entries(s) for s in jax.tree.leaves(
                                lm.cache_specs(cfg, pol))],
                            "local_shapes": local}}
    out["variants"][name] = v
mesh8 = Mesh(devs[:8].reshape(2, 2, 2), ("pod", "data", "model"))
pol = make_policy(mesh8, fsdp_over_pod=True, ep_over_pod=True)
for roles in {offset_roles!r}:
    idx = NamedSharding(mesh8, pol.spec(*roles)).devices_indices_map({offset_shape!r})
    out["offsets"][str(roles)] = [
        [[sl.indices(n)[0] for sl, n in zip(idx[d], {offset_shape!r})],
         [len(range(*sl.indices(n))) for sl, n in zip(idx[d], {offset_shape!r})]]
        for d in devs[:8]]
print("JSON" + json.dumps(out))
"""

PORT = """
import json
from repro_torch.configs import ARCHS
from tests._torch_dist import policy_layouts
print("JSON" + json.dumps(policy_layouts(sorted(ARCHS))))
"""


def _json(stdout: str) -> dict:
    return json.loads(next(line[4:] for line in stdout.splitlines() if line.startswith("JSON")))


@pytest.fixture(scope="module")
def layouts():
    """(the reference's, the port's): both subprocesses, side by side."""
    from concurrent.futures import ThreadPoolExecutor

    code = REFERENCE.format(variants=POLICY_VARIANTS, roles=ROLES, archs=ARCH_NAMES,
                            offset_roles=OFFSET_ROLES, offset_shape=OFFSET_SHAPE)
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(run_devices, code, 512, 600)
        port = pool.submit(run_devices, PORT, 1, 600)
        return _json(ref.result()), _json(port.result())


VARIANTS = [v[0] for v in POLICY_VARIANTS]


@pytest.mark.parametrize("variant", VARIANTS)
def test_policy_and_roles_equal_the_references(layouts, variant):
    ref, port = (side["variants"][variant] for side in layouts)
    assert port["policy"] == ref["policy"]
    assert port["resolve"] == ref["resolve"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_cache_specs_equal_the_references(layouts, variant, arch):
    ref, port = (side["variants"][variant]["archs"][arch] for side in layouts)
    assert port["param_specs"] == ref["param_specs"]
    assert port["cache_specs"] == ref["cache_specs"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_local_shapes_equal_jax_shard_shapes(layouts, variant, arch):
    """Rank 0's shard of every parameter has JAX's ``shard_shape``; where JAX
    refuses the spec (a mesh axis named twice: ``fsdp_over_pod`` with
    ``ep_over_pod`` on an expert leaf), the port's placements refuse it."""
    ref, port = (side["variants"][variant]["archs"][arch] for side in layouts)
    assert len(port["local_shapes"]) == len(ref["local_shapes"])
    uneven = []
    for i, (got, want) in enumerate(zip(port["local_shapes"], ref["local_shapes"])):
        if isinstance(want, str):
            assert isinstance(got, str) and "appears twice" in got, (i, got, want)
            assert "DuplicateSpec" in want or "more than once" in want or "twice" in want, want
            continue
        if got != want:
            uneven.append((i, got, want))
    assert uneven == []


def test_refused_specs_are_the_expert_leaves_under_both_pod_knobs(layouts):
    """The only specs either side refuses: the expert leaves' ``("pod",
    "model")`` ep with ``("pod", "data")`` fsdp (both knobs on)."""
    for variant in VARIANTS:
        for arch in ARCH_NAMES:
            local = layouts[1]["variants"][variant]["archs"][arch]["local_shapes"]
            refused = [i for i, x in enumerate(local) if isinstance(x, str)]
            big_moe = ARCHS[arch].n_experts >= 16
            assert bool(refused) == (variant == "multi/both/gather" and big_moe), (variant, arch)


@pytest.mark.parametrize("roles", [str(r) for r in OFFSET_ROLES])
def test_tuple_axes_lay_out_major_to_minor(layouts, roles):
    ref, port = (side["offsets"][roles] for side in layouts)
    assert port == ref


@pytest.mark.parametrize("variant", ["single", "multi"])
def test_production_mesh_shapes(layouts, variant):
    """``tests/test_system.py:test_production_mesh_shapes``' invariants."""
    mesh = layouts[1]["variants"][variant]["mesh"]
    assert mesh == layouts[0]["variants"][variant]["mesh"]
    if variant == "single":
        assert mesh == {"shape": [16, 16], "names": ["data", "model"], "size": 256}
    else:
        assert mesh == {"shape": [2, 16, 16], "names": ["pod", "data", "model"], "size": 512}


# ---------------------------------------------------------------------------
# the policy without a process group
# ---------------------------------------------------------------------------


def test_partition_spec_normalises_as_jax_does():
    from jax.sharding import PartitionSpec as P

    for entries in [(("data",), None, "model"), (("pod", "data"), None), (None,), ()]:
        assert tuple(PartitionSpec(*entries)) == tuple(P(*entries))
    spec = PartitionSpec(("pod", "data"), None, "model")
    assert spec.axes() == [(0, "pod"), (0, "data"), (2, "model")]
    assert spec.axes_of(1) == () and spec.axes_of(2) == ("model",)


def test_no_mesh_is_a_no_op():
    pol = ShardingPolicy()
    x = torch.ones(2, 3)
    assert pol.shard(x, "batch", "tp") is x
    assert pol.named("batch") is None and pol.named_from_spec(pol.spec("tp")) is None
    assert pol.tp_size == 1 and pol.dp_size == 1 and pol.spec("batch", "tp") == (None, None)
    assert make_policy(None) == ShardingPolicy()
    params = {"w": torch.ones(2)}
    assert lm.distribute_params(params, ARCHS["phi4-mini-3.8b"].reduced(), pol) is params
    with pytest.raises(ValueError):
        pol.placements(pol.spec("tp"))
    with pytest.raises(ValueError):
        pol.resolve("nope")


def test_placements_refuse_what_jax_refuses():
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    pol = make_policy(mesh, fsdp_over_pod=True, ep_over_pod=True)
    with pytest.raises(ValueError, match="twice"):
        pol.placements(pol.spec("ep", "fsdp"))
    with pytest.raises(ValueError, match="order"):
        pol.placements(PartitionSpec(("data", "pod"), None))
    with pytest.raises(ValueError, match="not in the mesh"):
        pol.placements(PartitionSpec("pipe"))


def test_replicated_constants_nest():
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    assert not disp._allow_implicit_replication
    with replicated_constants():
        with replicated_constants():
            assert disp._allow_implicit_replication
        assert disp._allow_implicit_replication
    assert not disp._allow_implicit_replication


def test_kernel_wrappers_refuse_a_dtensor(tmp_path):
    """A DTensor reaching any kernel wrapper raises on the CPU too (no
    silent plain version on a shard), naming the training route."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))

        def dt(*shape):
            return DTensor.from_local(torch.rand(shape), mesh, [Replicate(), Replicate()])

        q, kv = dt(1, 2, 8, 16), dt(1, 1, 8, 16)
        x, a, b = dt(1, 8, 2, 4), dt(1, 8, 2), dt(1, 8, 1, 4)
        calls = {"flash_attention": lambda: ops.attention(q, kv, kv),
                 "decode_attention": lambda: ops.decode_attention(q[:, :, 0], kv, kv),
                 "ssd_scan": lambda: ops.ssd(x, a, b, b, chunk=8),
                 "rglru_scan": lambda: ops.rglru(a, a),
                 "spike_accum": lambda: ops.spike_currents(dt(4), dt(4, 3)),
                 "spike_accum_blocks": lambda: ops.spike_currents_blocks(
                     dt(2, 4), torch.zeros(1, dtype=torch.int32), dt(1, 4, 3))}
        for name, call in calls.items():
            with pytest.raises(TypeError, match=f"{name}: a DTensor"):
                call()
    finally:
        dist.destroy_process_group()
