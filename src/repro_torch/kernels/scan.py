"""CUDA wrappers for the sequence-scan kernels (``csrc/scan.cu``).

* :func:`ssd_scan` replaces the Pallas ``repro/kernels/ssd_scan.py:ssd_scan``
  (:81): Mamba-2's chunked SSD scan (prefill of ``ssm`` layers) on the
  tensor cores: the ``[N, P]`` state carried across chunks by one block
  per (batch, head), then every (batch, chunk, head)'s output in parallel;
  the final state returned on request.
* :func:`rglru_scan` replaces the Pallas
  ``repro/kernels/rglru_scan.py:rglru_scan`` (:53): the diagonal
  recurrence ``h_t = a_t ⊙ h_{t-1} + b_t``, its trace returned (prefill of
  ``rglru`` layers).

Both take and return float32 in the JAX kernels' layouts and raise their
``ValueError``s on bad shapes.  The SSD scan is bound by the tensor
cores' rate at mamba2-1.3b's shapes (its products run as 3xTF32) and the
RG-LRU scan by memory; the source says what each design does about it,
and :func:`ssd_plan` and :func:`rglru_plan` give their launch geometry.
The TPU kernel's tiling arguments (``rglru_scan``'s ``chunk`` and
``block_d``) have no counterpart here: :func:`rglru_plan` picks the channel
tile from the shape, and each tile runs over the whole sequence in one
pass.

The wrappers take contiguous CUDA tensors only: they check device, dtype,
shape and contiguity, allocate the output with ``torch.empty``, launch on
the current stream, raise when the launch reports an error, and count
their launches in :data:`~repro_torch.kernels._build.LAUNCHES`.  The
dispatch between these kernels and their plain versions lives in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import LAUNCHES, SMS, blocks_per_sm, load_library, raise_on

__all__ = ["ssd_scan", "ssd_plan", "rglru_scan", "rglru_plan"]

SSD_HEAD_DIMS = (16, 32, 64, 128)
SSD_MAX_CHUNK = 128
SSD_MAX_STATE = 128  # N; a multiple of 8 (16-byte rows for cp.async)
# csrc/scan.cu's K5 constants: threads per block, padded chunk rows, the
# k-chunk depth and stages of the cp.async ring
_SSD_THREADS, _SSD_ROWS, _SSD_KC, _SSD_STAGES = 256, 128, 32, 3


def ssd_plan(bs: int, s: int, h: int, g: int, p: int, n: int, chunk: int, sms: int = SMS) -> dict:
    """Launch geometry of :func:`ssd_scan` (``csrc/scan.cu``): the three
    kernels' grids, their shared memory and how many of their blocks share
    an SM, the (batch, chunk, head) items each chunk-scan block walks
    (enough blocks for two an SM), and the workspace bytes (the in-chunk
    cumsum, C Bᵀ per group and the states entering each chunk)."""
    l = min(chunk, s)
    nc = s // l
    items = bs * nc * h
    per = -(-items // (2 * sms))
    lda, ldbt, ldx = _SSD_KC + 4, SSD_MAX_STATE + 8, p + 8
    smem = {
        "cb": 4 * _SSD_STAGES * 2 * _SSD_ROWS * lda,
        "state": 4 * (_SSD_STAGES * _SSD_KC * (ldbt + ldx) + 2 * _SSD_ROWS),
        "scan": 4 * _SSD_STAGES * (_SSD_ROWS * lda + _SSD_KC * ldx + _SSD_ROWS),
    }
    return {
        "chunk": l, "n_chunks": nc, "threads": _SSD_THREADS, "items_per_scan_block": per,
        "grid": {"cb": g * nc * bs, "state": h * bs, "scan": -(-items // per)},
        "smem": smem,
        "blocks_per_sm": {k: blocks_per_sm(v, _SSD_THREADS) for k, v in smem.items()},
        "workspace": {"cum": 4 * bs * h * s, "cb": 4 * bs * nc * g * _SSD_ROWS**2,
                      "states": 4 * bs * h * nc * n * p},
    }


# csrc/scan.cu's K6 constants: threads per block, floats of a (and of b)
# per ring stage, stages of the ring
_RG_THREADS, _RG_STAGE_FLOATS, _RG_STAGES = 128, 2048, 4
RG_WIDTHS = (128, 64, 32)  # channel tiles the kernel is built for, widest first


def rglru_plan(bs: int, s: int, d: int, sms: int = SMS) -> dict:
    """Launch geometry of :func:`rglru_scan` (``csrc/scan.cu``): the widest
    channel tile ``width`` whose grid of ``(ceil(d / width), bs)`` blocks
    covers nine tenths of the SMs (the narrowest where none does), the
    ring's ``steps`` per stage and ``stages``, the ring stages the longest
    block walks, the shared memory (the source owns this size: the card
    tests hold the library's count to it), how many blocks share an SM,
    and the bytes of a and b each block keeps in flight (every stage but
    the one being read)."""
    for width in RG_WIDTHS:
        if bs * -(-d // width) * 10 >= 9 * sms:
            break
    steps = _RG_STAGE_FLOATS // width
    smem = 2 * _RG_STAGES * _RG_STAGE_FLOATS * 4
    grid = (-(-d // width), bs)
    per_sm = blocks_per_sm(smem, _RG_THREADS)
    return {"width": width, "steps": steps, "stages": _RG_STAGES, "n_stages": -(-s // steps),
            "threads": _RG_THREADS, "grid": grid, "smem": smem, "blocks_per_sm": per_sm,
            "waves": -(-grid[0] * grid[1] // (per_sm * sms)),
            "bytes_in_flight": 2 * 4 * (_RG_STAGES - 1) * _RG_STAGE_FLOATS}


_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = load_library("scan")
        lib.ssd_scan_launch.argtypes = [_P] * 9 + [_I] * 8 + [_P]
        lib.ssd_scan_launch.restype = _I
        lib.ssd_scan_smem_bytes.argtypes = [_I, _I]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        lib.rglru_scan_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
        lib.rglru_scan_launch.restype = _I
        lib.rglru_scan_smem_bytes.argtypes = []
        lib.rglru_scan_smem_bytes.restype = ctypes.c_longlong
        _bound = lib
    return _bound


def _check(name: str, **tensors: torch.Tensor) -> torch.device:
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: all inputs must lie on one CUDA device, got "
                f"{[str(x.device) for x in tensors.values()]}"
            )
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return dev


def ssd_scan(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
    return_state: bool = False,
):
    """Chunked SSD scan on the card.

    x ``[B, S, H, P]`` (Δ-scaled), a ``[B, S, H]`` decay in (0, 1], b/c
    ``[B, S, G, N]`` with ``H % G == 0`` and N a multiple of 8 up to 128;
    ``chunk = min(chunk, S)`` must divide S and be at most 128 (any length,
    not only powers of two); x, b and c must start on a 16-byte boundary
    (a fresh tensor does).  Returns y ``[B, S, H, P]``, and with
    ``return_state`` also the final state ``h_S`` ``[B, H, N, P]`` float32.
    """
    if x.dim() != 4 or b.dim() != 4:
        raise ValueError(f"bad shapes x={tuple(x.shape)} a={tuple(a.shape)} b={tuple(b.shape)}")
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (tuple(a.shape) != (bs, s, h) or c.shape != b.shape or tuple(b.shape[:2]) != (bs, s)
            or g == 0 or h % g):
        raise ValueError(f"bad shapes x={tuple(x.shape)} a={tuple(a.shape)} b={tuple(b.shape)}")
    chunk = min(chunk, s)
    if chunk <= 0 or s % chunk:
        raise ValueError("S must divide chunk")
    if chunk > SSD_MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} > {SSD_MAX_CHUNK}")
    if p not in SSD_HEAD_DIMS:
        raise ValueError(f"ssd_scan: head dim {p} not in {SSD_HEAD_DIMS}")
    if n % 8 or not 0 < n <= SSD_MAX_STATE:
        raise ValueError(f"ssd_scan: state size {n} must be a multiple of 8 up to {SSD_MAX_STATE}")
    dev = _check("ssd_scan", x=x, a=a, b=b, c=c)
    for key, t in (("x", x), ("b", b), ("c", c)):  # copied 16 bytes at a time (cp.async)
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_scan: {key} must start on a 16-byte boundary")
    nc = s // chunk
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per = ssd_plan(bs, s, h, g, p, n, chunk, sms)["items_per_scan_block"]
    y = torch.empty_like(x)
    state = torch.empty((bs, h, n, p), dtype=torch.float32, device=dev) if return_state else None
    # one workspace: the states entering each chunk [B, H, nc, N, P], C Bᵀ
    # [B, nc, G, 128, 128] (both 16-byte aligned for cp.async), the
    # in-chunk cumsum [B, H, S]
    n_states, n_cb = bs * h * nc * n * p, bs * nc * g * _SSD_ROWS**2
    work = torch.empty(n_states + n_cb + bs * h * s, dtype=torch.float32, device=dev)
    states = work.data_ptr()
    with torch.cuda.device(dev):
        err = _lib().ssd_scan_launch(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
            None if state is None else state.data_ptr(), states + 4 * (n_states + n_cb),
            states + 4 * n_states, states, bs, s, h, g, n, p, chunk, per,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_on(err, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return (y, state) if return_state else y


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The gated diagonal recurrence on the card.

    a ``[B, S, D]`` decay gates in (0, 1), b ``[B, S, D]`` gated inputs.
    Returns the state trace h ``[B, S, D]`` (``h_{-1} = 0``).  One launch,
    in the geometry of :func:`rglru_plan`.
    """
    if b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} != b {tuple(b.shape)}")
    if a.dim() != 3:
        raise ValueError(f"a must be [B, S, D], got {tuple(a.shape)}")
    dev = _check("rglru_scan", a=a, b=b)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    bs, s, d = a.shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    width = rglru_plan(bs, s, d, sms)["width"]
    with torch.cuda.device(dev):
        err = _lib().rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), bs, s, d, width,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_on(err, "rglru_scan")
    LAUNCHES["rglru_scan"] += 1
    return out
