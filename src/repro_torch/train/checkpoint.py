"""Sharded checkpointing on torch: atomic, async, device-elastic — the
port of ``repro.train.checkpoint``, in the same on-disk format.

Layout: ``<dir>/step_<N>/`` holding ``params.npz`` (and
``opt_state.npz``) plus ``manifest.json`` (step, ``has_opt_state``,
meta, a CRC-32 per shard file).  Writes go to ``step_<N>.tmp`` and are
renamed only after the manifest is fsync'd — a crash mid-write never
corrupts the latest checkpoint (restart picks the newest complete
manifest).

A state is a tree of dicts, lists and tuples (``None`` holds no leaf)
whose leaves are tensors, numpy arrays or scalars.  A leaf's npz key is
its path, joined with ``/``: a dict node contributes its key (dict keys
in sorted order), a list or tuple node its index — the reference's rule
for a JAX pytree of the same shape, so a checkpoint written by either
package restores in the other.  npz cannot hold bf16: bf16 leaves are
stored as float32 and cast back to the target's dtype on restore.

Integrity: ``restore`` verifies the manifest's checksums before
deserializing and raises :class:`CheckpointCorruptError` on mismatch,
and ``latest_step(..., intact_only=True)`` walks steps newest-first to
the first checkpoint whose checksums verify.  Checkpoints without a
``checksums`` key are trusted as-is.

``restore(..., device=...)`` places the restored tensors on ``device``
(the counterpart of the reference's re-placing under a new mesh: the
bytes are device-independent); without it each tensor lands where the
target's leaf lives.  Async: ``save_async`` copies every leaf to the
host on the caller's thread — a snapshot, since torch state is written
in place — and serializes on a worker thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "save",
    "restore",
    "latest_step",
    "verify_checkpoint",
    "CheckpointCorruptError",
    "Checkpointer",
]


class CheckpointCorruptError(ValueError):
    """A checkpoint file's bytes do not match its manifest checksum."""


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _leaves(tree: Any, prefix: tuple = ()):
    """``(path, leaf)`` in the reference's pytree order: dict keys sorted,
    sequence indices in order, ``None`` an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, prefix + (i,))
    else:
        yield prefix, tree


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _host(leaf: Any) -> np.ndarray:
    """A host copy of one leaf in its stored dtype (bf16 → float32); never
    a view of the caller's memory."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:  # npz cannot serialize bf16
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _snapshot(tree: Any) -> Any:
    """``tree`` with every leaf replaced by its host copy."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    return _host(tree)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    """``{npz key: host array}``; a numpy leaf (``save_async``'s snapshot)
    is written as it is, not copied again."""
    return {_key(path): leaf if isinstance(leaf, np.ndarray) else _host(leaf)
            for path, leaf in _leaves(tree)}


def save(
    ckpt_dir: str,
    step: int,
    params: Any,
    opt_state: Any | None = None,
    *,
    meta: dict | None = None,
) -> str:
    """Blocking atomic save.  Returns the final directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "params.npz"), **_flatten(params))
    if opt_state is not None:
        np.savez(os.path.join(tmp, "opt_state.npz"), **_flatten(opt_state))
    shard_files = ["params.npz"] + (["opt_state.npz"] if opt_state is not None else [])
    manifest = {
        "step": step,
        "has_opt_state": opt_state is not None,
        "meta": meta or {},
        "checksums": {f: _crc32_file(os.path.join(tmp, f)) for f in shard_files},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def verify_checkpoint(ckpt_dir: str, step: int) -> bool:
    """True when the checkpoint's manifest parses and every recorded
    shard checksum matches the bytes on disk (a checkpoint without
    ``checksums`` verifies trivially)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    for fname, crc in manifest.get("checksums", {}).items():
        path = os.path.join(d, fname)
        if not os.path.exists(path) or _crc32_file(path) != crc:
            return False
    return True


def _steps(ckpt_dir: str) -> list[int]:
    return [int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
            if name.startswith("step_") and not name.endswith(".tmp")]


def latest_step(ckpt_dir: str, *, intact_only: bool = False) -> int | None:
    """Newest checkpoint step, or ``None``.  With ``intact_only`` the
    scan walks newest-first and returns the first checkpoint whose
    checksums verify — the corrupt-latest fallback the supervisor's
    rollback rung relies on."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for s in _steps(ckpt_dir)
             if os.path.exists(os.path.join(ckpt_dir, f"step_{s:08d}", "manifest.json"))]
    if not intact_only:
        return max(steps) if steps else None
    for s in sorted(steps, reverse=True):
        if verify_checkpoint(ckpt_dir, s):
            return s
    return None


def _restored(arr: np.ndarray, leaf: Any, device: torch.device | None) -> Any:
    """One stored array as the target leaf's kind and dtype: a tensor on
    ``device`` (else on the leaf's device) for a tensor leaf or when a
    device is given, else a numpy array."""
    if isinstance(leaf, torch.Tensor):
        t = torch.from_numpy(arr).to(leaf.dtype)  # bf16 round-trips via f32
        return t.to(leaf.device if device is None else device)
    if hasattr(leaf, "dtype") and arr.dtype != leaf.dtype:
        arr = arr.astype(leaf.dtype)
    return arr if device is None else torch.from_numpy(arr).to(device)


def _unflatten(target: Any, data: dict[str, np.ndarray], device: torch.device | None,
               prefix: tuple = ()) -> Any:
    if target is None:
        return None
    if isinstance(target, dict):
        return {k: _unflatten(v, data, device, prefix + (k,)) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten(v, data, device, prefix + (i,))
                            for i, v in enumerate(target))
    key = _key(prefix)
    arr = data[key]
    if tuple(arr.shape) != tuple(np.shape(target)):
        raise ValueError(f"{key}: checkpoint shape {arr.shape} != {tuple(np.shape(target))}")
    return _restored(arr, target, device)


def restore(
    ckpt_dir: str,
    step: int,
    target_params: Any,
    target_opt: Any | None = None,
    *,
    device: str | torch.device | None = None,
):
    """Restore into the structure of ``target_*``; returns ``(params,
    [opt_state,] manifest)``.  ``device`` places every restored tensor
    there; without it a tensor leaf is restored onto the target leaf's
    device and a numpy leaf as a numpy array."""
    dev = None if device is None else resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    for fname, crc in manifest.get("checksums", {}).items():
        path = os.path.join(d, fname)
        if not os.path.exists(path) or _crc32_file(path) != crc:
            raise CheckpointCorruptError(
                f"{path}: bytes do not match the manifest checksum "
                f"(torn write or bit-rot) — fall back with "
                f"latest_step(..., intact_only=True)"
            )
    with np.load(os.path.join(d, "params.npz")) as z:
        out = [_unflatten(target_params, dict(z), dev)]
    if target_opt is not None:
        if not manifest["has_opt_state"]:
            raise ValueError("checkpoint has no optimizer state")
        with np.load(os.path.join(d, "opt_state.npz")) as z:
            out.append(_unflatten(target_opt, dict(z), dev))
    out.append(manifest)
    return tuple(out)


class Checkpointer:
    """Async checkpointer: snapshot on the caller thread (a host copy of
    every leaf), serialize/write on a worker thread, keep_n retention."""

    def __init__(self, ckpt_dir: str, *, keep_n: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_n = keep_n
        self._thread: threading.Thread | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(
        self,
        step: int,
        params: Any,
        opt_state: Any | None = None,
        *,
        meta: dict | None = None,
    ):
        self.wait()
        # copies, not views: a later in-place write must not reach the
        # bytes being written
        host_p = _snapshot(params)
        host_o = _snapshot(opt_state)

        def work():
            save(self.ckpt_dir, step, host_p, host_o, meta=meta)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        for s in sorted(_steps(self.ckpt_dir))[: -self.keep_n]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
