"""GPipe over the port's communicators (``repro_torch.sharding.pipeline``)
against the sequential composition and the reference's ``gpipe``.

``tests/test_pipeline.py``'s case made with numpy: 4 stages of
``tanh(h @ w + b)``, d = 16, batch 8, 4 microbatches (and 2 and 8).  The
reference's ``gpipe`` runs once in a subprocess on 4 fake host devices
(``run_devices``), the port's through ``LoopbackComm`` on a ``(4,)`` mesh
and through ``ProcessGroupComm`` on 4 gloo ranks
(``tests/_torch_dist.py:gpipe_rank``).  Tolerance rtol = atol = 1e-5; the
loopback's and the processes' outputs are bit-equal.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.sharding.pipeline import bubble_fraction as jax_bubble_fraction
from repro_torch.sharding import bubble_fraction, gpipe
from repro_torch.snn import LoopbackComm
from tests._torch_dist import gpipe_rank, spawn
from tests.conftest import run_devices

N_STAGES, D, B = 4, 16, 8
MICROBATCHES = [4, 2, 8]


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(N_STAGES, D, D)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(N_STAGES, D)) * 0.1).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    return w, b, x


def _stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _sequential(w, b, x):
    h = torch.from_numpy(x)
    for s in range(N_STAGES):
        h = torch.tanh(h @ torch.from_numpy(w[s]) + torch.from_numpy(b[s]))
    return h.numpy()


REFERENCE = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.sharding.pipeline import gpipe
z = np.load({src!r})
mesh = make_mesh((4,), ("pipe",))
out = {{}}
for mb in {mbs!r}:
    run = gpipe(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), mesh, n_microbatches=mb)
    out[str(mb)] = np.asarray(run({{"w": jnp.asarray(z["w"]), "b": jnp.asarray(z["b"])}},
                                  jnp.asarray(z["x"])))
np.savez({dst!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gpipe")
    w, b, x = _inputs()
    np.savez(tmp / "in.npz", w=w, b=b, x=x)
    code = REFERENCE.format(src=str(tmp / "in.npz"), dst=str(tmp / "out.npz"),
                            mbs=MICROBATCHES)
    assert "OK" in run_devices(code, n_devices=4)
    return dict(np.load(tmp / "out.npz"))


def test_bubble_fraction():
    assert bubble_fraction(4, 4) == 3 / 7
    assert bubble_fraction(1, 8) == 0.0
    for s, m in [(2, 3), (4, 8), (16, 1)]:
        assert bubble_fraction(s, m) == jax_bubble_fraction(s, m)


@pytest.mark.parametrize("mb", MICROBATCHES)
def test_loopback_gpipe_matches_sequential_and_the_reference(reference, mb):
    w, b, x = _inputs()
    comm = LoopbackComm((N_STAGES,), "cpu")
    y = gpipe(_stage, comm, n_microbatches=mb)(
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x)).numpy()
    assert y.shape == x.shape
    np.testing.assert_allclose(y, _sequential(w, b, x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, reference[str(mb)], rtol=1e-5, atol=1e-5)


def test_process_gpipe_is_the_loopbacks_bit_for_bit(reference, tmp_path):
    w, b, x = _inputs()
    loop = gpipe(_stage, LoopbackComm((N_STAGES,), "cpu"), n_microbatches=4)(
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x)).numpy()
    outs = spawn(gpipe_rank, N_STAGES, tmp_path, w, b, x, 4)
    for y in outs:  # every rank holds the output
        assert np.array_equal(y, loop)
    np.testing.assert_allclose(outs[0], reference["4"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[0], _sequential(w, b, x), rtol=1e-5, atol=1e-5)


def test_gpipe_on_a_two_level_mesh_pipelines_each_inner_position():
    """On a ``(2, 2)`` loopback mesh ``"slow"`` runs two 2-stage pipelines
    side by side (held ranks 2g + i are stage g); ``"joint"`` one 4-stage
    pipeline over every rank."""
    w, b, x = _inputs(1)
    comm = LoopbackComm((2, 2), "cpu")
    slow = {"w": torch.from_numpy(w[[0, 0, 1, 1]]), "b": torch.from_numpy(b[[0, 0, 1, 1]])}
    y = gpipe(_stage, comm, axis="slow", n_microbatches=2)(slow, torch.from_numpy(x)).numpy()
    want = np.tanh(np.tanh(x @ w[0] + b[0]) @ w[1] + b[1])
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)
    y = gpipe(_stage, comm, axis="joint", n_microbatches=4)(
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, _sequential(w, b, x), rtol=1e-5, atol=1e-5)


def test_every_stage_applies_its_block_every_tick():
    """The reference's schedule: S + M − 1 ticks, every stage calls the
    stage function every tick, in a Python loop over the held stages."""
    calls = []
    w, b, x = _inputs()

    def counted(p, h):
        calls.append(h.shape)
        return _stage(p, h)

    gpipe(counted, LoopbackComm((N_STAGES,), "cpu"), n_microbatches=2)(
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x))
    assert len(calls) == N_STAGES * (N_STAGES + 2 - 1)
    assert all(tuple(s) == (B // 2, D) for s in calls)


def test_gpipe_refuses_what_it_cannot_run():
    comm = LoopbackComm((N_STAGES,), "cpu")
    with pytest.raises(ValueError):
        gpipe(_stage, comm, axis="inner", n_microbatches=2)
    with pytest.raises(ValueError):
        gpipe(_stage, comm, n_microbatches=0)
    w, b, x = _inputs()
    run = gpipe(_stage, comm, n_microbatches=3)
    with pytest.raises(ValueError):
        run({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x))
