"""Renderer tests (SURVEY §4 tier 5): golden-hash framebuffer, visual
semantics, PNG encoding."""

import hashlib
import struct
import zlib

import jax
import numpy as np
import pytest

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.core.init import init_state
from pyqmd_tpu.render import png_bytes, render_to_host, write_apng, write_png
from pyqmd_tpu.state import (
    ALPHA,
    ELECTRON,
    GAMMA,
    NEUTRON,
    PARTICLE_COLORS,
    PROTON,
    empty_state,
)

W, H = 160, 120


def _single_particle_state(cfg, ptype, x=400.0, y=400.0):
    st = empty_state(cfg)
    return st.replace(
        pos=st.pos.at[0].set(jax.numpy.array([x, y])),
        ptype=st.ptype.at[0].set(ptype),
        alive=st.alive.at[0].set(True),
    )


def test_proton_renders_red_with_highlight():
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    st = _single_particle_state(cfg, PROTON)
    img = render_to_host(st, (400.0, 400.0), 4.0, W, H, ruler=False)
    cx, cy = W // 2, H // 2
    # Rim of the circle is the base proton color (highlight sits up-left of
    # center, rendering.py:72-80).
    assert tuple(img[cy, cx + 8]) == tuple(PARTICLE_COLORS[PROTON])
    # Highlight color present near center.
    region = img[cy - 6 : cy + 2, cx - 6 : cx + 2].reshape(-1, 3)
    assert any((tuple(p) == (255, 150, 150)) for p in region)
    # Background black.
    assert tuple(img[5, 5]) == (0, 0, 0)


def test_neutron_renders_blue_with_ring():
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    st = _single_particle_state(cfg, NEUTRON)
    img = render_to_host(st, (400.0, 400.0), 4.0, W, H, ruler=False)
    cx, cy = W // 2, H // 2
    assert tuple(img[cy, cx]) == tuple(PARTICLE_COLORS[NEUTRON])
    # Ring color at radius-1 (rendering.py:81-85): radius = floor(2.5*4)=10.
    assert tuple(img[cy, cx + 9]) == (150, 150, 200)


def test_y_sort_order():
    """Overlapping nucleons: the one with larger world y draws on top
    (rendering.py:42-44)."""
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    st = empty_state(cfg)
    st = st.replace(
        pos=st.pos.at[0].set(jax.numpy.array([400.0, 400.0]))
        .at[1].set(jax.numpy.array([400.5, 400.5])),
        ptype=st.ptype.at[0].set(PROTON).at[1].set(NEUTRON),
        alive=st.alive.at[0].set(True).at[1].set(True),
    )
    img = render_to_host(st, (400.0, 400.0), 4.0, W, H, ruler=False)
    cx, cy = W // 2, H // 2
    # Center pixel covered by both; neutron (larger y) wins.
    assert tuple(img[cy + 1, cx + 1]) == tuple(PARTICLE_COLORS[NEUTRON])


def test_ejecta_fade_and_overdraw():
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    st = empty_state(cfg)
    # Half-faded gamma ejecta.
    st = st.replace(
        ej_pos=st.ej_pos.at[0].set(jax.numpy.array([400.0, 400.0])),
        ej_type=st.ej_type.at[0].set(GAMMA),
        ej_age=st.ej_age.at[0].set(1.0),
        ej_life=st.ej_life.at[0].set(2.0),
        ej_alive=st.ej_alive.at[0].set(True),
        ej_cursor=jax.numpy.asarray(1, jax.numpy.int32),
    )
    img = render_to_host(st, (400.0, 400.0), 4.0, W, H, ruler=False)
    cx, cy = W // 2, H // 2
    # Gamma (0,255,0) at 50% fade -> (0,127,0) (rendering.py:47, 66-68).
    assert img[cy, cx, 1] in (127, 128)
    assert img[cy, cx, 0] == 0


def test_ruler_burned_in():
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    st = empty_state(cfg)
    img = render_to_host(st, (400.0, 400.0), 15.0, 320, 240, ruler=True)
    # Ruler line at y = H-50, starting x=50 (rendering.py:101-106).
    assert tuple(img[240 - 50, 60]) == (200, 200, 200)


def test_golden_hash_fixed_state():
    """Deterministic render: fixed seed/state -> fixed image hash on the
    CPU test backend. Pins the whole visual stack (init RNG, rasterizer,
    ruler); update the stored hash deliberately if visuals change."""
    cfg = SimConfig.for_isotope(6, 8, pad_to=8)
    st = init_state(cfg, seed=42)
    img = render_to_host(st, (400.0, 400.0), 10.0, W, H)
    h = hashlib.sha256(img.tobytes()).hexdigest()
    img2 = render_to_host(st, (400.0, 400.0), 10.0, W, H)
    assert hashlib.sha256(img2.tobytes()).hexdigest() == h
    if jax.default_backend() == "cpu":
        assert h == (
            "074164acd52ac0fd4d7abb90484db86da1a287700d250a4a703d2dc04ce12789"
        )
    # The frame actually contains the nucleus (non-black pixels).
    assert (img.sum(-1) > 0).sum() > 50


def test_png_roundtrip(tmp_path):
    img = (np.arange(W * H * 3, dtype=np.uint32) % 256).astype(np.uint8).reshape(H, W, 3)
    data = png_bytes(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    assert (w, h) == (W, H)
    # Decode the IDAT back and compare (filter 0 rows).
    idat_off = data.index(b"IDAT") + 4
    idat_len = struct.unpack(">I", data[idat_off - 8 : idat_off - 4])[0]
    raw = zlib.decompress(data[idat_off : idat_off + idat_len])
    rows = np.frombuffer(raw, np.uint8).reshape(H, 1 + W * 3)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(H, W, 3), img)
    p = tmp_path / "x.png"
    write_png(str(p), img)
    assert p.read_bytes() == data


def test_apng(tmp_path):
    frames = [np.full((8, 8, 3), i * 40, np.uint8) for i in range(3)]
    p = tmp_path / "anim.png"
    write_apng(str(p), frames, fps=10)
    data = p.read_bytes()
    assert b"acTL" in data and b"fcTL" in data and b"fdAT" in data
    assert struct.unpack(">I", data[data.index(b"acTL") + 4 : data.index(b"acTL") + 8])[0] == 3


def test_ensemble_montage():
    from pyqmd_tpu import Simulation

    sim = Simulation(z=2, n=2, pad_to=8, ensemble=6)
    grid = sim.render_grid(nx=3, ny=2, tile=40)
    assert grid.shape == (80, 120, 3)
    assert (grid.sum(-1) > 0).sum() > 100  # nuclei visible
    import pytest

    single = Simulation(z=2, n=2, pad_to=8)
    with pytest.raises(RuntimeError):
        single.render_grid()


def test_ruler_nice_value_across_zooms():
    """The fm scale bar picks a 'nice' length and stays in-frame across the
    interactive zoom range (rendering.py:87-113 semantics)."""
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    st = empty_state(cfg)
    for zoom in (0.1, 1.0, 15.0, 100.0):
        img = render_to_host(st, (400.0, 400.0), zoom, 320, 240, ruler=True)
        row = img[240 - 50]
        lit = np.flatnonzero((row == 200).all(-1))
        assert len(lit) > 2, zoom  # bar exists
        assert lit.min() >= 48 and lit.max() < 320, zoom  # in frame


def test_ruler_label_burned_in():
    """The '<nice> fm' bitmap label appears above the ruler
    (rendering.py:115-116 equivalent)."""
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    st = empty_state(cfg)
    img = render_to_host(st, (400.0, 400.0), 15.0, 480, 360, ruler=True)
    label_region = img[360 - 50 - 25 : 360 - 50 - 11, 50:150]
    assert (label_region.sum(-1) > 0).sum() > 50  # glyph pixels lit


# --- font + panels (rendering.py:135-380 equivalents) ------------------------


def test_font_full_glyph_coverage():
    from pyqmd_tpu.render.font import render_text, text_width

    for s in ("U-238", "Half-life: 4.47e+03 million years",
              "U-238 → Th-234 (α)", "β-", "γ", "164.30 μs", "↑ More ↑"):
        m = render_text(s, scale=1)
        assert m.shape == (7, len(s) * 6)
        assert m.sum() > 0, s
    # Every printable char the panels use has a real glyph.
    import string

    for ch in string.ascii_letters + string.digits + ".,:-+/()[]<>=%'!?*":
        assert render_text(ch, 1).sum() > 0, repr(ch)
    assert render_text("\x7f", 1).sum() == 0  # unknown -> blank
    assert text_width("ab", 2) == 24


def test_compose_panels_info_content():
    """The info panel burns the reference's items (rendering.py:135-246):
    exact text bitmaps at the tracked line positions."""
    from pyqmd_tpu import Simulation
    from pyqmd_tpu.render.font import render_text
    from pyqmd_tpu.render.panels import compose_panels

    sim = Simulation(z=92, n=146, seed=0, pad_to=128)
    rgb, mask = compose_panels(
        800, 600, sim.status(), sim.chain_entries(),
        max_substeps=sim.max_substeps,
    )
    assert rgb.shape == (600, 800, 3) and mask.shape == (600, 800)
    x, lh = 10, 18  # scale=2 layout
    lines = {
        0: ("Acceleration: CPU (JNP)", (100, 255, 100)),
        1: ("Zoom: 15.0x", (200, 200, 255)),
        2: ("Element: Uranium (U)", (255, 255, 255)),
        3: ("Isotope: U-238", (255, 255, 255)),
        4: ("Protons: 92", (255, 100, 100)),
        5: ("Neutrons: 146", (100, 100, 255)),
    }
    for i, (text, color) in lines.items():
        m = render_text(text, 2) > 0
        y = 10 + i * lh
        region = mask[y : y + m.shape[0], x : x + m.shape[1]]
        np.testing.assert_array_equal(region, m, err_msg=text)
        assert (rgb[y : y + m.shape[0], x : x + m.shape[1]][m] == color).all(), text
    # Half-life line color-coded green for U-238 (>1M years bucket).
    m = render_text("Half-life: 4.47e+03 million years", 2) > 0
    y = 10 + 6 * lh
    np.testing.assert_array_equal(mask[y : y + 14, x : x + m.shape[1]], m)
    assert (rgb[y : y + 14, x : x + m.shape[1]][m] == (100, 255, 100)).all()


def test_compose_panels_decay_chain_content():
    from pyqmd_tpu import Simulation
    from pyqmd_tpu.render.panels import CHAIN_BG, CHAIN_CURRENT, compose_panels

    sim = Simulation(z=92, n=146, seed=0, pad_to=128)
    for _ in range(3):
        sim.force_decay()
    assert sim.isotope == "U-234"  # U-238 -> Th-234 -> Pa-234 -> U-234
    rgb, mask = compose_panels(
        800, 600, sim.status(), sim.chain_entries(),
        max_substeps=sim.max_substeps,
    )
    right = rgb[:, 570:]
    # Panel background present (rendering.py:255-257).
    assert (np.all(right == CHAIN_BG, axis=-1)).sum() > 1000
    # Current (most recent) entry highlighted (rendering.py:349-351).
    assert (np.all(right == CHAIN_CURRENT, axis=-1)).sum() > 10
    # Decay Statistics counters present: ALPHA color (255,200,0) in the left
    # column (one alpha so far).
    left = rgb[:, :300]
    assert (np.all(left == (255, 200, 0), axis=-1)).sum() > 10


def test_compose_panels_scroll_clamps():
    from pyqmd_tpu.render.panels import compose_panels

    chain = [
        dict(index=i, parent=(92, 146 - i), child=(92, 145 - i),
             symbol="α", duration=1.0)
        for i in range(30)
    ]
    status = dict(isotope="U-238", time_scale=1.0, substeps=4,
                  decay_counts=[0] * 8)
    # Absurd scroll values must clamp, not crash (rendering.py:289-292).
    for scroll in (0, 5, 10**6, -3):
        rgb, mask = compose_panels(400, 300, status, chain, chain_scroll=scroll)
        assert mask.any()


def test_render_with_panels_golden():
    """Full frame with burned-in panels: deterministic and distinct from the
    panel-less frame; panel pixels match the composed overlay exactly."""
    from pyqmd_tpu import Simulation
    from pyqmd_tpu.render.panels import compose_panels

    sim = Simulation(z=92, n=146, seed=0, pad_to=128)
    sim.force_decay()
    img = sim.render(640, 480)
    bare = sim.render(640, 480, panels=False)
    assert img.shape == bare.shape == (480, 640, 3)
    assert (img != bare).any()
    rgb, mask = compose_panels(
        640, 480, sim.status(), sim.chain_entries(),
        max_substeps=sim.max_substeps, chain_scroll=sim.chain_scroll,
    )
    np.testing.assert_array_equal(img[mask], rgb[mask])
    np.testing.assert_array_equal(img[~mask], bare[~mask])
    # Deterministic across calls.
    np.testing.assert_array_equal(sim.render(640, 480), img)


def test_windowed_matches_full_frame_path():
    """The windowed painter path and the full-frame winner path are
    bitwise-identical across zooms (same f32 coverage math)."""
    from pyqmd_tpu.render.framebuffer import _render_full, render_frame

    cfg = SimConfig.for_isotope(26, 30, pad_to=8)
    st = init_state(cfg, seed=3)
    st = st.replace(  # a couple of ejecta too
        ej_pos=st.ej_pos.at[0].set(jax.numpy.array([405.0, 398.0]))
        .at[1].set(jax.numpy.array([404.0, 399.0])),
        ej_type=st.ej_type.at[0].set(ALPHA).at[1].set(GAMMA),
        ej_age=st.ej_age.at[0].set(0.5).at[1].set(0.2),
        ej_life=st.ej_life.at[0].set(2.0).at[1].set(1.0),
        ej_alive=st.ej_alive.at[0].set(True).at[1].set(True),
        ej_cursor=jax.numpy.asarray(2, jax.numpy.int32),
    )
    for zoom in (0.5, 4.0, 10.0, 15.0):
        a = np.asarray(render_frame(st, (400.0, 400.0), zoom, 320, 240))
        b = np.asarray(_render_full(st, (400.0, 400.0), zoom, 320, 240))
        np.testing.assert_array_equal(a, b, err_msg=f"zoom={zoom}")
    # Huge zoom falls back to the full path (discs larger than any window).
    big = np.asarray(render_frame(st, (400.0, 400.0), 100.0, 320, 240))
    assert big.shape == (240, 320, 3)


def test_render_frame_traced_zoom_falls_back():
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    st = init_state(cfg, seed=0)
    from pyqmd_tpu.render import render_frame

    f = jax.jit(lambda s, z: render_frame(s, (400.0, 400.0), z, 160, 120))
    img = np.asarray(f(st, 10.0))
    ref = np.asarray(render_frame(st, (400.0, 400.0), 10.0, 160, 120))
    np.testing.assert_array_equal(img, ref)


def test_info_panel_scroll_and_resize():
    """Info-panel scroll shifts the column up (rendering.py:140) and
    Simulation.resize sets the default viewport (nuclear_sim.py:419-428)."""
    from pyqmd_tpu import Simulation
    from pyqmd_tpu.render.panels import compose_panels

    sim = Simulation(z=92, n=146, seed=0, pad_to=128)
    r0, m0 = compose_panels(640, 480, sim.status(), None, info_scroll=0)
    r2, m2 = compose_panels(640, 480, sim.status(), None, info_scroll=2)
    # Scrolling by 2 lines moves line 2's content to line 0.
    lh = 18
    np.testing.assert_array_equal(m0[10 + 2 * lh : 10 + 2 * lh + 14, :300],
                                  m2[10 : 10 + 14, :300])
    sim.resize(320, 240)
    img = sim.render()
    assert img.shape == (240, 320, 3)
    sim.info_scroll = 3
    img2 = sim.render()
    assert (img != img2).any()


def test_windowed_matches_full_at_frame_edges():
    """Particles at and beyond the frame edges exercise the window-origin
    clamping; output must still equal the full-frame path exactly."""
    from pyqmd_tpu.render.framebuffer import _render_full, render_frame

    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    st = empty_state(cfg)
    # Centered camera at (400, 400), zoom 8, frame 160x120: place particles
    # at the corners, just outside, and straddling each edge.
    spots = [
        (400.0, 400.0),   # center
        (390.2, 392.6),   # top-left corner region
        (410.0, 407.5),   # bottom-right corner region
        (388.0, 400.0),   # beyond the left edge (disc partially visible)
        (400.0, 409.0),   # beyond the bottom edge
        (370.0, 400.0),   # fully offscreen
    ]
    for k, (x, y) in enumerate(spots):
        st = st.replace(
            pos=st.pos.at[k].set(jax.numpy.array([x, y])),
            ptype=st.ptype.at[k].set(PROTON if k % 2 else NEUTRON),
            alive=st.alive.at[k].set(True),
        )
    a = np.asarray(render_frame(st, (400.0, 400.0), 8.0, 160, 120, ruler=False))
    b = np.asarray(_render_full(st, (400.0, 400.0), 8.0, 160, 120, ruler=False))
    np.testing.assert_array_equal(a, b)
    assert (a.sum(-1) > 0).sum() > 100  # scene actually drawn


def test_gif_exact_roundtrip(tmp_path):
    """Movies with ≤256 unique colors encode losslessly; verified against
    an independent decoder (PIL) when available, structurally otherwise."""
    from pyqmd_tpu.render import gif_bytes, write_gif

    frames = []
    base = np.zeros((24, 32, 3), np.uint8)
    base[:, :, 2] = 30
    for i in range(4):
        f = base.copy()
        f[4 + i : 12 + i, 3 + 2 * i : 11 + 2 * i] = (200, 40, 40)
        frames.append(f)
    data = gif_bytes(frames, fps=10)
    assert data[:6] == b"GIF89a" and data[-1:] == b"\x3b"
    w, h = struct.unpack("<HH", data[6:10])
    assert (w, h) == (32, 24)
    assert b"NETSCAPE2.0" in data  # looping extension
    # One image descriptor (0x2C block) per frame.
    assert data.count(b"\x21\xf9") == len(frames)  # graphic-control blocks
    p = tmp_path / "anim.gif"
    write_gif(str(p), frames, fps=10)
    assert p.read_bytes() == data
    PIL = pytest.importorskip("PIL.Image")
    from PIL import ImageSequence

    im = PIL.open(str(p))
    decoded = [np.array(fr.convert("RGB")) for fr in ImageSequence.Iterator(im)]
    assert len(decoded) == len(frames)
    for a, b in zip(frames, decoded):
        np.testing.assert_array_equal(a, b)


def test_gif_quantized_and_static_frames():
    """>256 unique colors falls back to the 6x7x6 cube (bounded error);
    identical consecutive frames still decode (1x1 changed-rect)."""
    from pyqmd_tpu.render import gif_bytes

    PIL = pytest.importorskip("PIL.Image")
    import io

    from PIL import ImageSequence

    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (16, 20, 3), dtype=np.uint8) for _ in range(2)]
    dec = [
        np.array(fr.convert("RGB"))
        for fr in ImageSequence.Iterator(PIL.open(io.BytesIO(gif_bytes(frames))))
    ]
    assert len(dec) == 2
    err = max(
        np.abs(a.astype(int) - b.astype(int)).max() for a, b in zip(frames, dec)
    )
    assert err <= 26  # half a quantization step on the coarsest channel

    static = [frames[0], frames[0].copy(), frames[0].copy()]
    dec = [
        np.array(fr.convert("RGB"))
        for fr in ImageSequence.Iterator(PIL.open(io.BytesIO(gif_bytes(static))))
    ]
    assert len(dec) == 3
    np.testing.assert_array_equal(dec[2], dec[0])


def test_gif_delta_frames_shrink_output():
    """Changed-rect encoding: a movie with a small moving sprite is much
    smaller than re-encoding the full canvas every frame (measured on the
    fixed-width path, where size tracks emitted pixels directly)."""
    from pyqmd_tpu.render import gif_bytes

    base = np.zeros((120, 160, 3), np.uint8)
    moving = []
    for i in range(8):
        f = base.copy()
        f[10 + i : 14 + i, 20 + i : 24 + i] = 255
        moving.append(f)
    n_moving = len(gif_bytes(moving, mode="fast"))
    # Same frame count but every pixel repainted each frame.
    repaint = [
        np.full((120, 160, 3), 10 * (i % 2), np.uint8) for i in range(8)
    ]
    n_repaint = len(gif_bytes(repaint, mode="fast"))
    assert n_moving < n_repaint / 5
    # The compact (true-LZW) path decodes identically and is no larger.
    assert len(gif_bytes(moving, mode="compact")) <= n_moving


def test_gif_palette_size_edges():
    """Palette-size boundaries: 2-color (min code size floor), 1-frame
    single color, exactly 256 (largest exact), 257 (quantized)."""
    from pyqmd_tpu.render import gif_bytes

    PIL = pytest.importorskip("PIL.Image")
    import io

    from PIL import ImageSequence

    def decode(data):
        return [
            np.array(fr.convert("RGB"))
            for fr in ImageSequence.Iterator(PIL.open(io.BytesIO(data)))
        ]

    two = [np.zeros((10, 12, 3), np.uint8) for _ in range(3)]
    for i, f in enumerate(two):
        f[i : i + 3, i : i + 3] = 128
    for a, b in zip(two, decode(gif_bytes(two))):
        np.testing.assert_array_equal(a, b)

    one = [np.full((5, 7, 3), 77, np.uint8)]
    np.testing.assert_array_equal(decode(gif_bytes(one))[0], one[0])

    full = np.zeros((16, 16, 3), np.uint8)
    full[..., 0] = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(decode(gif_bytes([full]))[0], full)

    over = full.copy()
    over[0, 0] = (1, 2, 3)
    assert len(decode(gif_bytes([full, over]))) == 2


def test_gif_compact_matches_fast_decode():
    """The variable-width LZW path and the fixed-width path decode to
    identical pixels across palette regimes (incl. a table-reset-sized
    noisy frame) — verified against an independent decoder."""
    from pyqmd_tpu.render import gif_bytes

    PIL = pytest.importorskip("PIL.Image")
    import io

    from PIL import ImageSequence

    def decode(data):
        return [
            np.array(fr.convert("RGB"))
            for fr in ImageSequence.Iterator(PIL.open(io.BytesIO(data)))
        ]

    rng = np.random.default_rng(1)
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    noisy = pal[rng.integers(0, 256, (120, 200))]  # forces LZW table resets
    grad = np.zeros((60, 256, 3), np.uint8)
    grad[..., 1] = np.arange(256, dtype=np.uint8)
    for frames in ([noisy, pal[rng.integers(0, 256, (120, 200))]], [grad]):
        fast = decode(gif_bytes(frames, mode="fast"))
        compact = decode(gif_bytes(frames, mode="compact"))
        for a, b, c in zip(frames, fast, compact):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, c)


def test_gif_lzw_strict_decoder_fuzz():
    """Both LZW paths against a spec-strict decoder (raises on truncated
    streams, out-of-table codes, or trailing bytes) over randomized
    frames — covers code-width growth, the widen-before-EOI edge, and
    table resets."""
    from pyqmd_tpu.render.gif import _lzw_fixed, _lzw_true

    def strict_decode(data, expected_px):
        min_code_size = data[0]
        stream = bytearray()
        i = 1
        while True:
            n = data[i]
            i += 1
            if n == 0:
                break
            stream += data[i : i + n]
            i += n
        assert i == len(data)  # no trailing bytes
        clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
        code_size = min_code_size + 1
        acc = nbits = pos = 0
        out = bytearray()
        table = prev = next_code = None

        def read():
            nonlocal acc, nbits, pos
            while nbits < code_size:
                assert pos < len(stream), "stream truncated"
                acc |= stream[pos] << nbits
                pos += 1
                nbits += 8
            c = acc & ((1 << code_size) - 1)
            acc >>= code_size
            nbits -= code_size
            return c

        while True:
            c = read()
            if c == clear:
                table = {k: bytes([k]) for k in range(clear)}
                next_code, code_size, prev = eoi + 1, min_code_size + 1, None
                continue
            if c == eoi:
                break
            if prev is None:
                assert c < clear
                out += table[c]
                prev = table[c]
                continue
            entry = table[c] if c < next_code else prev + prev[:1]
            assert c <= next_code, "code beyond table"
            out += entry
            table[next_code] = prev + entry[:1]
            next_code += 1
            if next_code == (1 << code_size) and code_size < 12:
                code_size += 1
            prev = entry
        assert len(out) == expected_px
        return bytes(out)

    rng = np.random.default_rng(7)
    for trial in range(300):
        h = int(rng.integers(1, 32))
        w = int(rng.integers(1, 32))
        ncol = int(rng.integers(2, 257))
        idx = rng.integers(0, ncol, (h, w)).astype(np.uint8)
        mcs = max(2, int(np.ceil(np.log2(max(ncol, 2)))))
        for enc in (_lzw_true, _lzw_fixed):
            assert strict_decode(enc(idx, mcs), h * w) == idx.tobytes()
    # Table-reset regime (>4096 sequences) and long runs.
    big = rng.integers(0, 256, (200, 300)).astype(np.uint8)
    assert strict_decode(_lzw_true(big, 8), big.size) == big.tobytes()
    runs = np.repeat(np.arange(64, dtype=np.uint8), 137)[: 64 * 64].reshape(64, 64)
    assert strict_decode(_lzw_true(runs, 6), runs.size) == runs.tobytes()


def test_gif_lzw_run_coalesced_bitwise_matches_reference():
    """The run-coalesced _lzw_true must produce the bitwise-identical code
    stream of the textbook per-pixel loop (_lzw_true_ref) — runs, mixed
    regions, table resets, every min-code-size."""
    from pyqmd_tpu.render.gif import _lzw_true, _lzw_true_ref

    rng = np.random.default_rng(11)
    cases = []
    for trial in range(120):
        h = int(rng.integers(1, 24))
        w = int(rng.integers(1, 24))
        ncol = int(rng.integers(2, 257))
        # Mix run-heavy and noisy frames.
        if trial % 2:
            base = rng.integers(0, ncol, (h, w)).astype(np.uint8)
        else:
            base = np.repeat(
                rng.integers(0, ncol, h * w // 5 + 1), 5
            )[: h * w].astype(np.uint8).reshape(h, w)
        cases.append((base, max(2, int(np.ceil(np.log2(max(ncol, 2)))))))
    # Table-reset regime: big noisy + long-run frames.
    cases.append((rng.integers(0, 256, (150, 200)).astype(np.uint8), 8))
    cases.append(
        (np.repeat(np.arange(16, dtype=np.uint8), 5000).reshape(200, 400), 4)
    )
    cases.append((np.zeros((80, 80), np.uint8), 2))  # single giant run
    cases.append((np.zeros((0,), np.uint8), 2))  # empty
    for idx, mcs in cases:
        assert _lzw_true(idx, mcs) == _lzw_true_ref(idx, mcs)


def test_packed_frame_bitwise_matches_rgb():
    """render_frame_packed + unpack_frame must reproduce the RGB frame
    byte-for-byte, including ejecta fade colors (VERDICT r4 item 4: the
    palettized interactive payload must not change pixels)."""
    from pyqmd_tpu.render import render_frame, render_frame_packed, unpack_frame

    cfg = SimConfig.for_isotope(6, 8, pad_to=16, max_ejecta=16)
    st = init_state(cfg, seed=3)
    # Live ejecta of every type with distinct fade fractions (distinct
    # palette entries), plus one dead slot.
    n_ej = min(6, st.ejecta_capacity)
    com = np.asarray(st.center_of_mass())
    for i in range(n_ej):
        st = st.replace(
            ej_pos=st.ej_pos.at[i].set(
                jax.numpy.array([com[0] - 25 + 10.0 * i, com[1] + 18.0])
            ),
            ej_type=st.ej_type.at[i].set([ALPHA, ELECTRON, GAMMA, NEUTRON,
                                          PROTON, ALPHA][i]),
            ej_age=st.ej_age.at[i].set(0.37 * i),
            ej_life=st.ej_life.at[i].set(3.0 if i else np.inf),
            ej_alive=st.ej_alive.at[i].set(i != 2),
        )
    cam = (float(com[0]), float(com[1]))
    rgb = np.asarray(render_frame(st, cam, 3.0, W, H, ruler=True))
    packed = np.asarray(render_frame_packed(st, cam, 3.0, W, H, ruler=True))
    assert packed.shape == (H + 2, W) and packed.dtype == np.uint8
    out = unpack_frame(packed)
    assert out is not None, "device exactness flag unset"
    assert np.array_equal(out, rgb)


def test_packed_frame_palette_overflow_raises():
    from pyqmd_tpu.render import render_frame_packed

    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    st = init_state(cfg, seed=0)
    with pytest.raises(ValueError):
        render_frame_packed(st, (400.0, 400.0), 4.0, 40, 30)  # 3*K > width


def test_pipelined_reader_delivers_all_frames_one_late():
    from pyqmd_tpu.render import (
        PipelinedFrameReader, render_frame, render_frame_packed,
    )

    cfg = SimConfig.for_isotope(2, 2, pad_to=8, max_ejecta=16)
    st = init_state(cfg, seed=1)
    cams = [(400.0 + 5.0 * i, 400.0) for i in range(6)]
    expected = [
        np.asarray(render_frame(st, c, 4.0, W, H)) for c in cams
    ]
    depth = 3
    reader = PipelinedFrameReader(depth=depth)
    got = []
    for c in cams:
        out = reader.submit(render_frame_packed(st, c, 4.0, W, H))
        if out is not None:
            got.append(out)
    assert len(got) == len(cams) - depth  # `depth` frames of latency
    got.extend(reader.flush())
    assert len(got) == len(cams)
    for g, e in zip(got, expected):
        assert np.array_equal(g, e)
    assert reader.flush() == []
    with pytest.raises(ValueError):
        PipelinedFrameReader(depth=0)


def test_render_fit_device_matches_host_fit():
    """The one-program device-fitted frame (in-graph camera fit + full-frame
    rasterizer) must reproduce the host _render_fit view — the watch loop
    shows these interchangeably."""
    from pyqmd_tpu.sim import Simulation

    sim = Simulation(z=6, n=8, pad_to=16)
    dev = np.asarray(sim.render_fit_device(64, 44))
    host = sim._render_fit(64, 44)
    assert dev.shape == host.shape == (44, 64, 3)
    # f32 in-graph camera vs f64 host camera: allow sub-pixel edge wobble
    # but demand near-total agreement (empirically exact on CPU).
    assert (dev == host).mean() > 0.995
