"""Low-latency interactive frame readback: indexed frames + pipelining.

The reference displays through an in-process PyGame window at 60 fps
(/root/reference/nuclear_sim.py:589-606); here every displayed frame is a
device-to-host copy (1.4 MB for 800x600 RGB). Two levers shrink and hide
that copy:

* **Palettized payload.** The rasterizer paints from a small closed set
  of colors: the per-type particle colors, the proton highlight, the
  neutron ring, the ruler, black, and one faded color per ejecta ring
  slot — at most ``10 + max_ejecta`` distinct RGBs. The device maps the
  rendered RGB frame to uint8 palette indices (exact match, no
  quantization) and ships ONE fused uint8 array: H index rows, one
  palette row, one flags row — a 3x smaller payload and a single copy.
  The host expands with one numpy gather; the result is byte-identical
  to the RGB readback (a device-verified flag guards the exactness, so
  an out-of-palette pixel — which should be impossible — falls back to
  the RGB path instead of corrupting the frame).

* **Pipelined copies.** Host copies overlap: issuing
  ``copy_to_host_async`` for frame t and blocking only on frame
  t-depth hides the copies behind each other. The
  ``PipelinedFrameReader`` below is that queue; it shows each frame
  ``depth`` frames late — a streaming viewer's latency/throughput knob.

Whether the GPU host needs either lever to reach 60 fps is not measured
yet (ROADMAP D6). RGB export paths (PNG/APNG/GIF, golden-hashed) are
untouched.
"""

from __future__ import annotations

import collections

import jax
import jax.numpy as jnp
import numpy as np

from pyqmd_tpu.render.framebuffer import (
    NEUTRON_RING,
    PROTON_HIGHLIGHT,
    RULER_COLOR,
    render_frame,
)
from pyqmd_tpu.state import PARTICLE_COLORS, NucleusState

# Palette layout: 0 background, 1-6 particle colors, 7 proton highlight,
# 8 neutron ring, 9 ruler, 10.. one entry per ejecta ring slot.
_BASE_PALETTE = np.concatenate(
    [
        np.zeros((1, 3), np.uint8),
        PARTICLE_COLORS,
        np.array([PROTON_HIGHLIGHT, NEUTRON_RING, RULER_COLOR], np.uint8),
    ]
)
N_BASE = _BASE_PALETTE.shape[0]  # 10


def palette_size(ejecta_capacity: int) -> int:
    return N_BASE + ejecta_capacity


@jax.jit
def _palettize(img, ej_type, ej_age, ej_life):
    """(H, W, 3) RGB -> (H+2, W) packed uint8: indices, palette, flags.

    The ejecta palette entries repeat the EXACT f32 fade math and uint8
    cast of the rasterizer (framebuffer.py ejecta fade), so every painted
    pixel matches an entry bit-for-bit; the flags row carries the
    device-verified all-pixels-matched bit and the palette length.
    """
    h, w, _ = img.shape
    colors = jnp.asarray(PARTICLE_COLORS.astype(np.float32))
    fade = jnp.where(
        jnp.isinf(ej_life), 0.0, ej_age / jnp.maximum(ej_life, 1e-9)
    )
    e_col = colors[ej_type] * (1.0 - jnp.minimum(fade, 1.0))[:, None]
    e_col = jnp.clip(e_col, 0, 255).astype(jnp.uint8)
    pal = jnp.concatenate([jnp.asarray(_BASE_PALETTE), e_col])  # (K, 3)
    k = pal.shape[0]

    w32 = jnp.asarray([1 << 16, 1 << 8, 1], jnp.uint32)
    ppx = jnp.sum(img.astype(jnp.uint32) * w32, axis=-1)  # (H, W)
    ppal = jnp.sum(pal.astype(jnp.uint32) * w32, axis=-1)  # (K,)
    eq = ppx[:, :, None] == ppal[None, None, :]  # (H, W, K)
    idx = jnp.argmax(eq, axis=-1).astype(jnp.uint8)
    ok = jnp.all(jnp.any(eq, axis=-1))

    pal_row = jnp.zeros((w,), jnp.uint8).at[: 3 * k].set(pal.reshape(-1))
    flag_row = (
        jnp.zeros((w,), jnp.uint8)
        .at[0].set(ok.astype(jnp.uint8))
        .at[1].set(np.uint8(k - 1))  # K-1 so K=256 still fits a byte
    )
    return jnp.concatenate([idx, pal_row[None], flag_row[None]], axis=0)


def render_frame_packed(
    state: NucleusState,
    camera,
    zoom,
    width: int = 800,
    height: int = 600,
    ruler: bool = True,
):
    """Rasterize and palettize one frame into a single (H+2, W) uint8
    device array (see module docstring for the layout). Raises
    ``ValueError`` when the palette cannot fit (ejecta capacity > 246 or
    3*K > width) — callers fall back to :func:`render_frame`.
    """
    k = palette_size(state.ejecta_capacity)
    if k > 256 or 3 * k > width:
        raise ValueError(
            f"palette of {k} entries does not fit (width {width}); "
            "use the RGB path"
        )
    img = render_frame(state, camera, zoom, width, height, ruler)
    return _palettize(img, state.ej_type, state.ej_age, state.ej_life)


def unpack_frame(packed: np.ndarray) -> np.ndarray | None:
    """Expand a host-side packed frame to (H, W, 3) uint8 RGB.

    Returns None when the device-side exactness flag is unset (some pixel
    matched no palette entry) — the caller should re-render via the RGB
    path. One numpy gather; ~1 ms for 800x600.
    """
    h = packed.shape[0] - 2
    flags = packed[h + 1]
    if not flags[0]:
        return None
    k = int(flags[1]) + 1
    pal = packed[h, : 3 * k].reshape(k, 3)
    return pal[packed[:h]]


class PipelinedFrameReader:
    """Depth-N frame queue: submit frame t's packed array, receive frame
    t-depth's RGB once the queue is full. Keeping ``depth`` async host
    copies in flight overlaps them. The cost is ``depth`` frames of
    display latency (~100 ms at 60 fps and depth 6) — the
    streaming-viewer tradeoff; drop ``depth`` for lower latency at lower
    throughput.
    """

    def __init__(self, depth: int = 6, decode=unpack_frame) -> None:
        """``decode`` maps the landed host array to the frame handed back
        (default: :func:`unpack_frame` for packed palettized frames; pass
        an identity for raw RGB device frames, as the CLI ``watch`` loop
        does). Returning None from decode drops that frame."""
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._depth = depth
        self._decode = decode
        self._queue: collections.deque = collections.deque()

    def submit(self, packed) -> np.ndarray | None:
        """Start the async host copy of ``packed``; once ``depth`` frames
        are in flight, return the OLDEST frame's decoded RGB (None while
        the pipeline fills, or when decode drops the frame)."""
        packed.copy_to_host_async()
        self._queue.append(packed)
        if len(self._queue) > self._depth:
            return self._decode(np.asarray(self._queue.popleft()))
        return None

    def flush(self) -> list[np.ndarray]:
        """Drain every in-flight frame (end of the loop), oldest first.
        Frames the decoder drops (None) are skipped."""
        out = []
        while self._queue:
            rgb = self._decode(np.asarray(self._queue.popleft()))
            if rgb is not None:
                out.append(rgb)
        return out
