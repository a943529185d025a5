"""Natural-image scenes: real photographic statistics with no download
(port of ``stif_tpu/data/natural.py``; numpy, and ``cv2`` inside the
functions that read or write images).

The reference's data pipeline targets natural video (Vimeo-90K /
Adobe240fps, ``codes/data/Vimeo7_dataset.py``, ``Adobe_dataset.py``). These
scenes take their TEXTURE from real photographs, the photographic material
textures bundled with ``dm_control`` (grass, wood, marble, skin), and their
MOTION is exact by construction:

  * the integer-pan family (``build_natural_eval_set``): each frame an
    integer-pixel crop of one photo, so x4-downscaled LR frames move by
    genuine subpixel steps with analytic ground truth;
  * the layered family (``sample_natural_scene``, ``render_natural_frame``,
    ``build_natural_eval_set_v2``): subpixel global affine motion of a
    background photo and independently moving occluding layers cut from
    photos, one cubic resample per layer: the training and eval proxy for
    real video.

If no bundled photo is found, ``find_natural_textures`` returns [] and
callers skip the family (the synthetic training set then draws its
procedural scenes).
"""

from __future__ import annotations

import os
import site
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Preferred bundled photographs (searched under every site-packages root);
# photographic material scans with broadband natural spectra.
_CANDIDATE_RELPATHS = [
    "dm_control/locomotion/arenas/assets/outdoor_natural/OutdoorGrassFloorD.png",
    "dm_control/suite/dog_assets/skin_texture.png",
    "gymnasium_robotics/envs/assets/adroit_hand/resources/textures/darkwood.png",
    "gymnasium_robotics/envs/assets/kitchen_franka/kitchen_assets/textures/white_marble_tile.png",
]


def find_natural_textures(max_n: int = 4) -> List[str]:
    """Paths of bundled photographic textures, deterministic order."""
    roots = list(site.getsitepackages())
    found = []
    for rel in _CANDIDATE_RELPATHS:
        for r in roots:
            p = os.path.join(r, rel)
            if os.path.exists(p):
                found.append(p)
                break
        if len(found) >= max_n:
            break
    return found


def render_pan_sequence(img: np.ndarray, n_frames: int,
                        size: Tuple[int, int],
                        vel: Tuple[int, int] = (3, 5),
                        origin: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """(n_frames, H, W, 3) float32 [0,1]: integer-pixel panning crops.

    ``img`` uint8/float HWC RGB; ``vel`` HR pixels/frame (integers — the
    crop is exact, no resampling). The x4-downscaled LR stream then moves
    vel/4 px/frame: subpixel motion with analytic ground truth.
    """
    H, W = size
    vy, vx = int(vel[0]), int(vel[1])
    need_h = H + abs(vy) * (n_frames - 1)
    need_w = W + abs(vx) * (n_frames - 1)
    ih, iw = img.shape[:2]
    assert ih >= need_h and iw >= need_w, \
        f"photo {ih}x{iw} too small for {n_frames} frames of {H}x{W} @ {vel}"
    y0 = (ih - need_h) // 2 if origin is None else origin[0]
    x0 = (iw - need_w) // 2 if origin is None else origin[1]
    if vy < 0:
        y0 += abs(vy) * (n_frames - 1)
    if vx < 0:
        x0 += abs(vx) * (n_frames - 1)
    f = img.astype(np.float32)
    if img.dtype == np.uint8:
        f = f / 255.0
    out = []
    for t in range(n_frames):
        yy = y0 + vy * t
        xx = x0 + vx * t
        out.append(f[yy:yy + H, xx:xx + W, :3])
    return np.stack(out)


# --------------------------------------------------------------------------
# Layered subpixel scenes: photographic textures with subpixel global affine
# motion and >= 2 independently moving occluding layers; each frame is one
# cubic resample of the source photos.
# --------------------------------------------------------------------------

_TEXTURE_CACHE: dict = {}
_TEXTURE_SHAPE: dict = {}


def _texture_shape(path: str) -> Tuple[int, int]:
    """(H, W) of the photo on disk, cached (scenes are sampled per training
    sample — re-reading the file each time would dominate render cost)."""
    if path not in _TEXTURE_SHAPE:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        _TEXTURE_SHAPE[path] = img.shape[:2]
    return _TEXTURE_SHAPE[path]


def _load_texture(path: str, ds: int = 1) -> np.ndarray:
    """(H, W, 3) float32 RGB in [0,1]; INTER_AREA-shrunk by ``ds``; cached."""
    import cv2

    key = (path, int(ds))
    if key not in _TEXTURE_CACHE:
        img = cv2.imread(path, cv2.IMREAD_COLOR)  # BGR uint8
        if ds > 1:
            img = cv2.resize(img, (img.shape[1] // ds, img.shape[0] // ds),
                             interpolation=cv2.INTER_AREA)
        _TEXTURE_CACHE[key] = np.ascontiguousarray(
            img[..., ::-1].astype(np.float32) / 255.0)
    return _TEXTURE_CACHE[key]


def sample_natural_scene(rng: np.random.Generator,
                         min_canvas: Tuple[int, int] = (256, 320),
                         n_fg: int = 2, max_speed: float = 3.0,
                         photos: Optional[Sequence[str]] = None) -> dict:
    """Draw a layered photographic scene (texture refs + float motions).

    The scene's ``canvas`` is the pre-shrunk background photo; callers crop
    ``(size, origin)`` windows out of it like ``synthetic.render_frame``.
    Background: global affine (float translation + slight rotation/zoom).
    Foreground: ``n_fg``+-1 near-opaque soft-edged elliptical patches cut
    from OTHER photo regions, each with an independent float velocity —
    crossing trajectories create true occlusion boundaries.
    """
    paths = list(photos) if photos is not None else find_natural_textures()
    if not paths:
        raise RuntimeError("no bundled photographic textures found")
    bg_path = paths[int(rng.integers(len(paths)))]
    ih, iw = _texture_shape(bg_path)
    ds_max = max(1, min(ih // min_canvas[0], iw // min_canvas[1]))
    ds = int(rng.integers(1, min(ds_max, 4) + 1))
    bg = _load_texture(bg_path, ds)
    Hc, Wc = bg.shape[:2]

    n = int(rng.integers(max(1, n_fg - 1), n_fg + 2))
    fg_paths = [paths[int(rng.integers(len(paths)))] for _ in range(n)]
    fg_tex, fg_src = [], []
    for p in fg_paths:
        fh, fw = _texture_shape(p)
        t = _load_texture(p, ds if p == bg_path else
                          max(1, min(min(fh, fw) // 256, 4)))
        fg_tex.append(t)
        fg_src.append([rng.uniform(64, max(65, t.shape[0] - 64)),
                       rng.uniform(64, max(65, t.shape[1] - 64))])
    return {
        "kind": "natural",
        "canvas": (Hc, Wc),
        "bg": bg,
        # global affine motion of the background (float px/frame — subpixel)
        "vel": rng.uniform(-max_speed, max_speed, 2).astype(np.float32),
        "omega": np.float32(rng.uniform(-0.003, 0.003)),
        "zoom": np.float32(rng.uniform(-0.0015, 0.0015)),
        "fg_tex": fg_tex,
        "fg_src": np.asarray(fg_src, np.float32),
        "fg_pos": np.stack([rng.uniform(0.2 * Hc, 0.8 * Hc, n),
                            rng.uniform(0.2 * Wc, 0.8 * Wc, n)],
                           -1).astype(np.float32),
        "fg_vel": rng.uniform(-1.4 * max_speed, 1.4 * max_speed,
                              (n, 2)).astype(np.float32),
        "fg_ab": rng.uniform(14.0, 52.0, (n, 2)).astype(np.float32),
        "fg_angle": rng.uniform(0, np.pi, n).astype(np.float32),
        "fg_opacity": rng.uniform(0.95, 1.0, n).astype(np.float32),
        # edge width (px, relative falloff): small -> crisp occlusion
        # boundary with an antialiased rim
        "fg_edge": rng.uniform(0.02, 0.08, n).astype(np.float32),
        "gain_slope": np.float32(0.0),
        "bias_slope": np.float32(0.0),
    }


def render_natural_frame(scene: dict, t: float, size: Tuple[int, int],
                         origin: Tuple[float, float] = (0.0, 0.0)
                         ) -> np.ndarray:
    """Render the (H, W) crop at canvas offset ``origin`` at continuous time
    ``t`` (frame units). One cubic resample per layer; float32 RGB [0,1]."""
    import cv2

    H, W = size
    y0, x0 = origin
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32) + float(y0),
                         np.arange(W, dtype=np.float32) + float(x0),
                         indexing="ij")
    Hc, Wc = scene["canvas"]
    cy, cx = Hc / 2.0, Wc / 2.0
    py = yy - cy - scene["vel"][0] * t
    px = xx - cx - scene["vel"][1] * t
    s = 1.0 + float(scene["zoom"]) * t
    th = float(scene["omega"]) * t
    c, sn = np.cos(th), np.sin(th)
    qy = (c * py + sn * px) / s + cy
    qx = (-sn * py + c * px) / s + cx
    img = cv2.remap(scene["bg"], qx.astype(np.float32),
                    qy.astype(np.float32), cv2.INTER_CUBIC,
                    borderMode=cv2.BORDER_REFLECT)

    for i in range(scene["fg_pos"].shape[0]):
        by = scene["fg_pos"][i, 0] + scene["fg_vel"][i, 0] * t
        bx = scene["fg_pos"][i, 1] + scene["fg_vel"][i, 1] * t
        dy = yy - by
        dx = xx - bx
        a, b = scene["fg_ab"][i]
        ang = float(scene["fg_angle"][i])
        ca, sa = np.cos(ang), np.sin(ang)
        u = (ca * dy + sa * dx) / a
        v = (-sa * dy + ca * dx) / b
        r = np.sqrt(u * u + v * v)
        edge = float(scene["fg_edge"][i])
        # clip the logit: far outside the ellipse (1-r)/edge is hugely
        # negative and np.exp overflows to inf (harmless value-wise — the
        # sigmoid underflows to 0 — but it spams RuntimeWarnings per crop)
        alpha = scene["fg_opacity"][i] / (
            1.0 + np.exp(np.clip(-(1.0 - r) / edge, -60.0, 60.0)))
        if float(alpha.max(initial=0.0)) < 1e-3:
            continue  # layer entirely outside this crop at this t
        sy, sx = scene["fg_src"][i]
        tex = cv2.remap(scene["fg_tex"][i],
                        (dx + sx).astype(np.float32),
                        (dy + sy).astype(np.float32), cv2.INTER_CUBIC,
                        borderMode=cv2.BORDER_REFLECT)
        img = img * (1.0 - alpha[..., None]) + tex * alpha[..., None]

    gs, bs = float(scene.get("gain_slope", 0)), float(scene.get(
        "bias_slope", 0))
    if gs or bs:
        img = img * (1.0 + gs * t) + bs * t
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def build_natural_eval_set_v2(root: str, n_scenes: int = 10,
                              n_frames: int = 12,
                              size: Tuple[int, int] = (144, 192),
                              seed0: int = 995_000) -> List[str]:
    """Render ``naturalv2_<k>`` PNG folders (idempotent): layered subpixel
    scenes — the hardened replacement for the integer-pan ``natural<k>``
    family (kept for provenance). >=8 scenes so per-family std is usable
    for gating. Returns folder names ([] when no photos are bundled)."""
    import cv2

    if not find_natural_textures():
        return []
    os.makedirs(root, exist_ok=True)
    names = []
    margin = int(np.ceil(4.5 * (n_frames - 1)))  # 1.4*3 px/frame fg max
    for k in range(n_scenes):
        name = f"naturalv2_{k}"
        d = os.path.join(root, name)
        names.append(name)
        if os.path.isdir(d) and len(os.listdir(d)) == n_frames:
            continue
        rng = np.random.default_rng(np.random.SeedSequence([seed0, k]))
        scene = sample_natural_scene(
            rng, min_canvas=(size[0] + 2 * margin, size[1] + 2 * margin))
        Hc, Wc = scene["canvas"]
        y0 = rng.uniform(margin, max(margin + 1, Hc - size[0] - margin))
        x0 = rng.uniform(margin, max(margin + 1, Wc - size[1] - margin))
        os.makedirs(d, exist_ok=True)
        for t in range(n_frames):
            img = render_natural_frame(scene, float(t), size, (y0, x0))
            u8 = (np.clip(img, 0, 1) * 255).round().astype(np.uint8)
            cv2.imwrite(os.path.join(d, f"{t:03d}.png"), u8[..., ::-1])
    return names


def build_natural_eval_set(root: str, n_frames: int = 12,
                           size: Tuple[int, int] = (144, 192),
                           vels: Sequence[Tuple[int, int]] = (
                               (3, 5), (-2, 6), (4, -3), (2, 2)),
                           pre_downscale: int = 4) -> List[str]:
    """Render ``natural<k>`` PNG folders under ``root`` (idempotent), one per
    bundled photo. Each photo is INTER_AREA-shrunk by the LARGEST factor
    <= ``pre_downscale`` that still fits the panning window, so crops carry
    broadband detail rather than close-up blur. Returns the rendered folder
    names ([] when no photos are bundled)."""
    import cv2

    photos = find_natural_textures()
    if not photos:
        return []
    os.makedirs(root, exist_ok=True)
    names = []
    for k, path in enumerate(photos):
        name = f"natural{k}"
        d = os.path.join(root, name)
        if os.path.isdir(d) and len(os.listdir(d)) == n_frames:
            names.append(name)
            continue
        img = cv2.imread(path, cv2.IMREAD_COLOR)  # BGR
        vel = vels[k % len(vels)]
        need_h = size[0] + abs(vel[0]) * (n_frames - 1)
        need_w = size[1] + abs(vel[1]) * (n_frames - 1)
        for ds in range(max(1, pre_downscale), 0, -1):
            if img.shape[0] // ds >= need_h and img.shape[1] // ds >= need_w:
                break
        else:
            continue  # photo too small even unscaled: skip it
        if ds > 1:
            img = cv2.resize(img, (img.shape[1] // ds, img.shape[0] // ds),
                             interpolation=cv2.INTER_AREA)
        clip = render_pan_sequence(img[..., ::-1], n_frames, size, vel=vel)
        os.makedirs(d, exist_ok=True)
        for t in range(n_frames):
            u8 = (np.clip(clip[t], 0, 1) * 255).round().astype(np.uint8)
            cv2.imwrite(os.path.join(d, f"{t:03d}.png"), u8[..., ::-1])
        names.append(name)
    return names
