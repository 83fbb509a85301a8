"""Image ops, ported from ``lidar_visual_odometry_tpu/ops/image.py``:
pyramids, gradients, bilinear sampling, corner scores, CLAHE and the per-cell
feature selection of the visual frontend.

* ``pyr_down`` ≡ the reference's 2×2-mean ``pyrDownMeanSmooth``
  (``src/vloam/Frame.cpp:407-444``);
* ``gradients`` ≡ the ±1 central differences of ``Tracker2.cpp:151-160``;
* ``bilinear`` ≡ per-patch interpolation (``Tracker2.cpp:124-150``) as a
  batched gather (the JAX package's one-hot ``bilinear_mxu`` is a TPU
  workaround and has no counterpart here); ``bilinear_stack`` samples
  several channels, or images of a stack, in one gather;
* ``shi_tomasi_score`` + ``grid_select_features`` ≡ featureTracking's
  per-subregion detection (``featureTracking.cpp:101,145-160,300-385``);
* ``clahe`` ≡ ``cv::createCLAHE(3.0, (8, 8))`` (``featureTracking.cpp:92-95``);
  ``normalize_contrast`` is its zero-mean, unit-std stand-in.

Images are (H, W) float32 in [0, 1], y-down pixel coords, ``uv = (x, y)``.
Divisions by constants multiply by the float32 reciprocal, as the reference's
compiler does under ``jit`` (``pointcloud._recip32``).
"""

from __future__ import annotations

import torch

from .pointcloud import _recip32


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """2×2 mean downsample (pyrDownMeanSmooth)."""
    H, W = img.shape[-2:]
    x = img[..., : H - H % 2, : W - W % 2]
    x = x.reshape(*x.shape[:-2], H // 2, 2, W // 2, 2)
    return (x[..., 0, :, 0] + x[..., 0, :, 1] + x[..., 1, :, 0] + x[..., 1, :, 1]) * 0.25


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """[level0 (full res), level1 (half), ...] (Frame.cpp:252-286)."""
    out = [img]
    for _ in range(levels - 1):
        out.append(pyr_down(out[-1]))
    return out


def gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients (dx, dy), same shape, zero at borders."""
    gx = torch.zeros_like(img)
    gx[..., :, 1:-1] = 0.5 * (img[..., :, 2:] - img[..., :, :-2])
    gy = torch.zeros_like(img)
    gy[..., 1:-1, :] = 0.5 * (img[..., 2:, :] - img[..., :-2, :])
    return gx, gy


def bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample an (H, W) image at float coords uv (..., 2) = (x, y); out of
    bounds clamps to the border (callers gate with in-image masks)."""
    return bilinear_stack(img[None, ..., None], uv)[..., 0]


def bilinear_stack(stack: torch.Tensor, uv: torch.Tensor, index=None) -> torch.Tensor:
    """Sample every channel of a channels-last stack (B, H, W, C) at uv
    (..., 2) = (x, y), from image ``index`` (an int tensor broadcasting
    against uv's leading axes; None for image 0): (..., C), in one gather.
    Out of bounds clamps to the border (callers gate with in-image masks)."""
    B, H, W, C = stack.shape
    x = torch.clamp(uv[..., 0], 0.0, W - 1.001)
    y = torch.clamp(uv[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    base = 0 if index is None else index * (H * W)
    flat = stack.reshape(-1, C)
    v00 = flat[base + y0 * W + x0]
    v01 = flat[base + y0 * W + x1]
    v10 = flat[base + y1 * W + x0]
    v11 = flat[base + y1 * W + x1]
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def box_sum(img: torch.Tensor, k: int) -> torch.Tensor:
    """k×k window sum with zero padding ('same') over the last two axes."""
    x = img.reshape(-1, *img.shape[-2:])
    s = torch.nn.functional.avg_pool2d(x, k, stride=1, padding=k // 2,
                                       count_include_pad=True, divisor_override=1)
    return s.reshape(img.shape)


def shi_tomasi_score(img: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Min-eigenvalue corner score map (what cv::goodFeaturesToTrack ranks)."""
    gx, gy = gradients(img)
    inv_area = _recip32(window * window)

    # the three box sums in one pooling of the (3, H, W) stack
    sxx, syy, sxy = box_sum(torch.stack([gx * gx, gy * gy, gx * gy]), window) * inv_area
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = torch.sqrt(torch.clamp(tr * tr * 0.25 - det, min=0.0))
    return tr * 0.5 - disc


def normalize_contrast(img: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Zero-mean, unit-std luminance (a cheap stand-in for CLAHE); the std is
    the population one, as ``jnp.std``."""
    return (img - img.mean()) / torch.clamp(img.std(correction=0), min=eps)


def clahe(img: torch.Tensor, *, grid: tuple[int, int] = (8, 8), clip_limit: float = 3.0,
          n_bins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization: per-tile clipped
    histogram → equalization LUT, pixels remapped by bilinear interpolation
    between the 4 surrounding tile LUTs; the clipped excess is redistributed
    uniformly in one pass. Input (H, W) float in [0, 1]; output the same."""
    H, W = img.shape
    gr, gc = grid
    th = -(-H // gr)
    tw = -(-W // gc)
    x = torch.nn.functional.pad(img[None, None], (0, gc * tw - W, 0, gr * th - H),
                                mode="replicate")[0, 0]

    b = torch.clamp(torch.round(x * (n_bins - 1)).to(torch.int64), 0, n_bins - 1)
    tiles = b.reshape(gr, th, gc, tw).permute(0, 2, 1, 3).reshape(gr * gc, th * tw)
    tile_ids = torch.arange(gr * gc, device=img.device)[:, None]
    flat = (tile_ids * n_bins + tiles).reshape(-1)
    hist = torch.zeros(gr * gc * n_bins, dtype=torch.float32, device=img.device)
    hist = hist.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    hist = hist.reshape(gr * gc, n_bins)

    area = float(th * tw)
    cl = max(clip_limit * area / n_bins, 1.0)
    excess = torch.clamp(hist - cl, min=0.0).sum(dim=1, keepdim=True)
    hist = torch.clamp(hist, max=cl) + excess * _recip32(n_bins)
    cdf = torch.cumsum(hist, 1)
    lut = torch.clamp(cdf * ((n_bins - 1) / area), 0.0, n_bins - 1.0)

    Hp, Wp = x.shape
    yy = (torch.arange(Hp, dtype=torch.float32, device=img.device) + 0.5) * _recip32(th) - 0.5
    xx = (torch.arange(Wp, dtype=torch.float32, device=img.device) + 0.5) * _recip32(tw) - 0.5
    y0 = torch.clamp(torch.floor(yy).to(torch.int64), 0, gr - 1)
    x0 = torch.clamp(torch.floor(xx).to(torch.int64), 0, gc - 1)
    y1 = torch.clamp(y0 + 1, max=gr - 1)
    x1 = torch.clamp(x0 + 1, max=gc - 1)
    fy = torch.clamp(yy - torch.floor(yy), 0.0, 1.0)[:, None]
    fx = torch.clamp(xx - torch.floor(xx), 0.0, 1.0)[None, :]
    # pixels above/left of the first tile centre stick to the edge tile
    fy = torch.where((yy < 0)[:, None], 0.0, fy)
    fx = torch.where((xx < 0)[None, :], 0.0, fx)

    lut_flat = lut.reshape(-1)

    def sample(ti_y, ti_x):
        tid = ti_y[:, None] * gc + ti_x[None, :]
        return lut_flat[tid * n_bins + b]

    v00 = sample(y0, x0)
    v01 = sample(y0, x1)
    v10 = sample(y1, x0)
    v11 = sample(y1, x1)
    out = (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx + v10 * fy * (1 - fx)
           + v11 * fy * fx) * _recip32(n_bins - 1)
    return out[:H, :W]


def grid_select_features(
    score: torch.Tensor,
    occupied_uv: torch.Tensor,
    occupied_mask: torch.Tensor,
    *,
    grid_rows: int,
    grid_cols: int,
    per_cell: int,
    min_score: float = 1e-5,
    suppression_radius: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cell top-k corner selection with existing-feature suppression.

    Pixels within ``suppression_radius`` of a tracked feature are masked, then
    each of the grid_rows × grid_cols cells takes ``per_cell`` masked arg-max
    sweeps (the first maximum on ties; a cell that is all -inf gives index 0).
    Returns (uv (grid_rows·grid_cols·per_cell, 2) float, valid mask)."""
    H, W = score.shape
    ch = H // grid_rows
    cw = W // grid_cols
    dev = score.device

    xi = torch.clamp(occupied_uv[:, 0].to(torch.int64), 0, W - 1)
    yi = torch.clamp(occupied_uv[:, 1].to(torch.int64), 0, H - 1)
    occ = torch.zeros(H * W, dtype=torch.int32, device=dev).index_add_(
        0, yi * W + xi, occupied_mask.to(torch.int32))
    r = suppression_radius
    occ_dil = torch.nn.functional.max_pool2d(
        (occ.reshape(1, H, W) > 0).to(torch.float32), 2 * r + 1, stride=1, padding=r)[0] > 0
    s = torch.where(occ_dil, -torch.inf, score)

    cells = s[: ch * grid_rows, : cw * grid_cols].reshape(
        grid_rows, ch, grid_cols, cw).permute(0, 2, 1, 3).reshape(grid_rows * grid_cols, ch * cw)
    cols_i = torch.arange(cells.shape[1], device=dev)[None, :]
    vlist, ilist = [], []
    x = cells
    for _ in range(per_cell):
        i = torch.argmax(x, dim=1)
        vlist.append(torch.gather(x, 1, i[:, None])[:, 0])
        ilist.append(i)
        x = torch.where(cols_i == i[:, None], -torch.inf, x)
    vals = torch.stack(vlist, dim=1)
    flat_idx = torch.stack(ilist, dim=1)

    cy = flat_idx // cw
    cx = flat_idx % cw
    cell_ids = torch.arange(grid_rows * grid_cols, device=dev)[:, None]
    row0 = (cell_ids // grid_cols) * ch
    col0 = (cell_ids % grid_cols) * cw
    uv = torch.stack([(col0 + cx).to(torch.float32), (row0 + cy).to(torch.float32)],
                     dim=-1).reshape(-1, 2)
    valid = (vals > min_score).reshape(-1)
    return uv, valid
