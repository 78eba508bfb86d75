"""The port's checkpoint (``repro_torch.train.checkpoint``) on the CPU: the
reference's on-disk format, so a checkpoint written by either package
restores in the other with equal values (nested dicts, lists and tuples;
bf16, f32 and int leaves); corrupt-latest fallback; ``save_async`` as a
snapshot against in-place writes; ``keep_n`` retention."""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.train import checkpoint as ck


def _arrays(seed: int = 0) -> dict:
    """The checkpointed state as numpy arrays (bf16 leaves kept in
    float32 with values a bf16 holds exactly)."""
    rng = np.random.default_rng(seed)
    def bf(*shape):  # float32 bits a bf16 holds exactly
        return rng.standard_normal(shape).astype(np.float32).view(np.uint32) & 0xFFFF0000

    return {
        "layers": [
            {"w": rng.standard_normal((3, 4)).astype(np.float32),
             "b": bf(4).view(np.float32)}
            for _ in range(2)
        ],
        "embed": (rng.integers(-50, 50, 5).astype(np.int32),
                  rng.standard_normal((2, 2)).astype(np.float32)),
        "scale": {"inner": {"g": bf(6).view(np.float32)}},
    }


def _is_bf16(path: tuple) -> bool:
    return path[-1] in ("b", "g")


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _torch_tree(arrays):
    return _map(arrays, lambda p, a: torch.from_numpy(a.copy()).to(
        torch.bfloat16 if _is_bf16(p) else torch.from_numpy(a).dtype))


def _jax_tree(arrays):
    import jax.numpy as jnp

    return _map(arrays, lambda p, a: jnp.asarray(a, jnp.bfloat16 if _is_bf16(p) else a.dtype))


def _assert_torch_equal(got, arrays):
    def check(p, a):
        leaf = _get(got, p)
        assert isinstance(leaf, torch.Tensor)
        assert leaf.dtype == (torch.bfloat16 if _is_bf16(p) else torch.from_numpy(a).dtype)
        np.testing.assert_array_equal(leaf.float().numpy() if _is_bf16(p) else leaf.numpy(), a)
    _map(arrays, check)


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def test_reference_checkpoint_restores_through_the_port(tmp_path):
    from repro.train import checkpoint as ref

    arrays = _arrays(0)
    opt = {"mu": [np.arange(6, dtype=np.float32).reshape(2, 3)], "count": np.int32(7)}
    ref.save(str(tmp_path), 5, _jax_tree(arrays), _jax_tree(opt), meta={"by": "reference"})
    assert ck.verify_checkpoint(str(tmp_path), 5)
    assert ck.latest_step(str(tmp_path), intact_only=True) == 5
    params, opt_state, manifest = ck.restore(
        str(tmp_path), 5, _torch_tree(_arrays(1)),
        {"mu": [torch.zeros(2, 3)], "count": torch.tensor(0, dtype=torch.int32)})
    _assert_torch_equal(params, arrays)
    assert torch.equal(opt_state["mu"][0], torch.arange(6.0).reshape(2, 3))
    assert opt_state["count"].item() == 7
    assert manifest["step"] == 5 and manifest["meta"] == {"by": "reference"}
    assert manifest["has_opt_state"] is True


def test_port_checkpoint_restores_through_the_reference(tmp_path):
    import jax.numpy as jnp

    from repro.train import checkpoint as ref

    arrays = _arrays(2)
    ck.save(str(tmp_path), 9, _torch_tree(arrays), {"t": torch.ones(3, dtype=torch.float64)},
            meta={"by": "port"})
    assert ref.verify_checkpoint(str(tmp_path), 9)
    target = _jax_tree(_arrays(3))
    params, opt_state, manifest = ref.restore(str(tmp_path), 9, target, {"t": np.zeros(3)})

    def check(p, a):
        leaf = _get(params, p)
        want = jnp.bfloat16 if _is_bf16(p) else a.dtype
        assert leaf.dtype == want
        np.testing.assert_array_equal(np.asarray(leaf).astype(a.dtype), a)
    _map(arrays, check)
    np.testing.assert_array_equal(opt_state["t"], np.ones(3))
    assert manifest["step"] == 9 and manifest["meta"] == {"by": "port"}


def test_npz_keys_and_manifest_are_the_reference_format(tmp_path):
    from repro.train import checkpoint as ref

    arrays = _arrays(4)
    ck.save(str(tmp_path / "port"), 3, _torch_tree(arrays))
    ref.save(str(tmp_path / "ref"), 3, _jax_tree(arrays))
    files = {}
    for who in ("port", "ref"):
        d = tmp_path / who / "step_00000003"
        assert sorted(os.listdir(d)) == ["manifest.json", "params.npz"]
        with np.load(d / "params.npz") as z:
            files[who] = {k: z[k] for k in z.files}
        man = json.loads((d / "manifest.json").read_text())
        assert sorted(man) == ["checksums", "has_opt_state", "meta", "step"]
        assert list(man["checksums"]) == ["params.npz"]
    assert list(files["port"]) == list(files["ref"])
    assert "layers/1/b" in files["port"] and "embed/0" in files["port"]
    for k, v in files["ref"].items():
        assert files["port"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(files["port"][k], v)
    assert files["port"]["scale/inner/g"].dtype == np.float32  # bf16 stored as f32


def _corrupt(path):
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))


def test_corrupt_latest_falls_back_and_raises(tmp_path):
    d = str(tmp_path)
    for step in (1, 2):
        ck.save(d, step, {"w": torch.full((8,), float(step))})
    _corrupt(tmp_path / "step_00000002" / "params.npz")
    assert ck.latest_step(d) == 2
    assert not ck.verify_checkpoint(d, 2) and ck.verify_checkpoint(d, 1)
    assert ck.latest_step(d, intact_only=True) == 1
    with pytest.raises(ck.CheckpointCorruptError, match="intact_only"):
        ck.restore(d, 2, {"w": torch.zeros(8)})
    params, _man = ck.restore(d, 1, {"w": torch.zeros(8)})
    assert torch.equal(params["w"], torch.ones(8))


def test_restore_refuses_a_wrong_shape_and_a_missing_opt_state(tmp_path):
    d = str(tmp_path)
    ck.save(d, 0, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(d, 0, {"w": torch.zeros(5)})
    with pytest.raises(ValueError, match="no optimizer state"):
        ck.restore(d, 0, {"w": torch.zeros(4)}, {"m": torch.zeros(4)})


def test_restore_places_on_the_device_asked_for(tmp_path):
    d = str(tmp_path)
    ck.save(d, 0, {"w": np.arange(4.0), "h": torch.ones(2, dtype=torch.bfloat16)})
    params, _ = ck.restore(d, 0, {"w": np.zeros(4), "h": torch.zeros(2, dtype=torch.bfloat16)},
                           device="cpu")
    assert isinstance(params["w"], torch.Tensor) and params["w"].dtype == torch.float64
    assert params["h"].dtype == torch.bfloat16 and params["h"].device.type == "cpu"
    params, _ = ck.restore(d, 0, {"w": np.zeros(4), "h": torch.zeros(2, dtype=torch.bfloat16)})
    assert isinstance(params["w"], np.ndarray)  # a numpy leaf stays numpy without a device
    np.testing.assert_array_equal(params["w"], np.arange(4.0))


def test_save_async_is_a_snapshot_against_in_place_writes(tmp_path, monkeypatch):
    """The worker writes only after the caller has written the state in
    place: the checkpoint still holds the values of the call."""
    written = threading.Event()
    save = ck.save

    def held_save(*a, **kw):
        assert written.wait(10)
        return save(*a, **kw)

    monkeypatch.setattr(ck, "save", held_save)
    state = {"v": torch.arange(16, dtype=torch.float32), "h": [np.zeros(3)]}
    opt = {"m": torch.ones(4, dtype=torch.bfloat16)}
    c = ck.Checkpointer(str(tmp_path))
    c.save_async(4, state, opt)
    state["v"].add_(100.0)  # the SNN writes its state like this
    state["h"][0] += 1.0
    opt["m"].mul_(3)
    written.set()
    c.wait()
    params, o, man = ck.restore(str(tmp_path), 4, state, opt)
    assert torch.equal(params["v"], torch.arange(16, dtype=torch.float32))
    np.testing.assert_array_equal(params["h"][0], np.zeros(3))
    assert torch.equal(o["m"], torch.ones(4, dtype=torch.bfloat16))
    assert man["step"] == 4


def test_keep_n_retention_and_stale_tmp_never_listed(tmp_path):
    d = str(tmp_path)
    stale = tmp_path / "step_00000009.tmp"
    stale.mkdir()
    (stale / "manifest.json").write_text(json.dumps({"step": 9}))
    c = ck.Checkpointer(d, keep_n=2)
    for step in range(5):
        c.save_async(step, {"w": torch.full((2,), float(step))})
    c.wait()
    kept = sorted(n for n in os.listdir(d) if not n.endswith(".tmp"))
    assert kept == ["step_00000003", "step_00000004"]
    assert stale.exists()  # retention leaves a stale .tmp alone ...
    assert ck.latest_step(d) == 4  # ... and it is never listed
    assert ck.latest_step(d, intact_only=True) == 4
    assert ck.latest_step(str(tmp_path / "missing")) is None
