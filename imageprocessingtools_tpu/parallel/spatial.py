"""Spatial (height) sharding of ONE giant image with halo exchange.

Image analog of sequence/context parallelism (survey §5): the H axis is
sharded over a mesh axis with `shard_map`; the 5x5 Gaussian needs a 2-row
halo, exchanged with `lax.ppermute`; global-boundary shards
replicate their own edge rows (matching `ops.stencil.gaussian_blur`'s
replicate padding bit-exactly); the histogram is a local bincount reduced
with `lax.psum`. Output equals the single-device fused pipeline exactly.

`resize_width_spatial` extends the same design to the reference bicubic
resize (survey §5's remaining deliverable): the H-pass weight matmul
contracts over the sharded dim, so instead of letting GSPMD all-reduce the
FULL resized output across the mesh (O(outH*W) bytes/device), each shard
exchanges only the halo rows its taps actually reach — computed exactly
from the contributions index range (`ops/_exact.calc_contributions`, ref
``ppmx-edward.c:563,587-589``) — with `lax.ppermute`, then applies its own
[outH/n, local+halo] weight block locally. O(taps*W)
bytes/device on the wire, identical math to the single-device op.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from imageprocessingtools_tpu.ops import _exact
from imageprocessingtools_tpu.ops.color import grayscale
from imageprocessingtools_tpu.ops.common import quantize_u8
from imageprocessingtools_tpu.ops.histogram import _equalize_lut, apply_lut, histogram
from imageprocessingtools_tpu.ops.resize import RESIZE_DOT_PRECISION


def _exchange_row_halo(tile: jnp.ndarray, radius: int, axis_name: str) -> jnp.ndarray:
    """Concatenate [halo_top, tile, halo_bottom] along H inside shard_map.

    Interior halos ride ppermute; the global top/bottom shards
    replicate their own edge row ``radius`` times (replicate padding).
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)

    top_rows = tile[:radius]
    bottom_rows = tile[-radius:]
    if n > 1:
        from_above = lax.ppermute(
            bottom_rows, axis_name, perm=[(i, i + 1) for i in range(n - 1)]
        )
        from_below = lax.ppermute(
            top_rows, axis_name, perm=[(i + 1, i) for i in range(n - 1)]
        )
    else:
        from_above = bottom_rows
        from_below = top_rows

    edge_top = jnp.repeat(tile[:1], radius, axis=0)
    edge_bottom = jnp.repeat(tile[-1:], radius, axis=0)
    halo_top = jnp.where(idx == 0, edge_top, from_above)
    halo_bottom = jnp.where(idx == n - 1, edge_bottom, from_below)
    return jnp.concatenate([halo_top, tile, halo_bottom], axis=0)


def _gaussian5_from_padded(padded: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """Integer binomial 5x5 on a row-halo'd int32 tile.

    Vertical pass is VALID over the 2-row halos; horizontal pass replicates
    edges locally (W is unsharded). Bit-identical to ops.stencil.gaussian_blur.
    """
    taps = (1, 4, 6, 4, 1)
    rows = None
    for dy, k in enumerate(taps):
        term = k * padded[dy : dy + h, :]
        rows = term if rows is None else rows + term
    rows = jnp.pad(rows, ((0, 0), (2, 2)), mode="edge")
    acc = None
    for dx, k in enumerate(taps):
        term = k * rows[:, dx : dx + w]
        acc = term if acc is None else acc + term
    return ((acc + 128) >> 8).astype(jnp.uint8)


def fused_pipeline_spatial(
    img: jnp.ndarray, mesh: Mesh, axis_name: str = "sp"
) -> jnp.ndarray:
    """gray -> gaussian5 -> hist-eq on one uint8[H, W, 3], H-sharded.

    H must be divisible by the mesh axis size, with >= 2 rows per shard.
    """
    height, width = int(img.shape[0]), int(img.shape[1])
    n = mesh.shape[axis_name]
    if height % n != 0 or height // n < 2:
        raise ValueError(f"H={height} must be divisible by {axis_name}={n} with >=2 rows/shard")
    return _fused_spatial_fn(height, width, mesh, axis_name)(img)


@functools.lru_cache(maxsize=32)
def _fused_spatial_fn(height: int, width: int, mesh: Mesh, axis_name: str):
    """One jit wrapper per (shape, mesh): repeat same-shape giant images
    (the serve --spatial loop) reuse the compile instead of recompiling per
    file."""
    n_pixels = height * width

    def local_fn(tile):  # uint8[H/n, W, 3]
        h = tile.shape[0]
        g = grayscale(tile).astype(jnp.int32)
        padded = _exchange_row_halo(g, radius=2, axis_name=axis_name)
        blurred = _gaussian5_from_padded(padded, h, width)
        hist = lax.psum(histogram(blurred), axis_name)
        lut = _equalize_lut(hist, n_pixels)
        return apply_lut(blurred, lut)

    sharded = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=P(axis_name),
    )
    return jax.jit(
        sharded,
        in_shardings=NamedSharding(mesh, P(axis_name)),
        out_shardings=NamedSharding(mesh, P(axis_name)),
    )


# ---------------------------------------------------------------------------
# Halo-exchange spatial RESIZE (survey §5's contributions-derived halo).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _spatial_resize_plan(height: int, width: int, new_width: int, n: int):
    """Host f64 plan for the H-sharded resize over ``n`` shards.

    Returns ``(new_height, passes)`` where each pass is
    ``("w", W_w f32[outW, W], 0, 0)`` (fully local — W is unsharded) or
    ``("h", Wb f32[outH, halo_top + H/n + halo_bot], halo_top, halo_bot)``
    whose rows ``[i*outH/n, (i+1)*outH/n)`` are shard i's weight block over
    its local rows plus the exchanged halo. The halo row counts are EXACT:
    the max over shards of how far the contributions tap indices
    (mirror-reflected, antialias-widened on downscale — ref
    ``ppmx-edward.c:563,587-589``) overhang the shard's local row range.

    Returns None when this layout cannot apply: H or new_height not
    divisible by n, or a halo deeper than one shard (extreme downscale vs
    shard height — would need multi-hop exchange); callers fall back to
    GSPMD then.
    """
    plan = _exact.plan_resize(height, width, new_width)
    if height % n or plan.new_height % n:
        return None
    local_h = height // n
    out_local = plan.new_height // n
    passes = []
    for dim, contrib in plan.passes:
        if dim == 1:
            passes.append(
                ("w", _exact.dense_weights(contrib, width).astype(np.float32),
                 0, 0))
            continue
        idx = contrib.indices                      # [outH, taps], in [0, H)
        halo_top = 0
        halo_bot = 0
        for i in range(n):
            rows = idx[i * out_local : (i + 1) * out_local]
            halo_top = max(halo_top, i * local_h - int(rows.min()))
            halo_bot = max(halo_bot, int(rows.max()) - ((i + 1) * local_h - 1))
        if halo_top > local_h or halo_bot > local_h:
            return None                            # would need multi-hop
        dense = _exact.dense_weights(contrib, height)      # f64 [outH, H]
        k = halo_top + local_h + halo_bot
        wb = np.zeros((plan.new_height, k), np.float64)
        for i in range(n):
            r0, r1 = i * out_local, (i + 1) * out_local
            c0 = i * local_h - halo_top            # global col of block col 0
            lo, hi = max(0, c0), min(height, c0 + k)
            # Cols outside [0, H) stay zero; they only exist because the
            # halo depth is the max over shards (a boundary shard's own
            # taps never reach them), and ppermute hands boundary shards
            # zeros for the missing neighbor — zero weight x zero data.
            wb[r0:r1, lo - c0 : hi - c0] = dense[r0:r1, lo:hi]
        passes.append(("h", wb.astype(np.float32), halo_top, halo_bot))
    return plan.new_height, tuple(passes)


def _exchange_rows_asym(tile, top: int, bot: int, axis_name: str):
    """[top-halo | tile | bot-halo] along H inside shard_map.

    Halo rows ride ppermute in the image's uint8 dtype (4x fewer
    bytes than post-cast f32). Boundary shards receive ppermute's zero
    fill for the missing neighbor; their weight-block columns there are
    zero, so the product is unaffected (no masking needed).
    """
    n = lax.axis_size(axis_name)
    parts = []
    if top:
        parts.append(lax.ppermute(
            tile[-top:], axis_name, perm=[(i, i + 1) for i in range(n - 1)]))
    parts.append(tile)
    if bot:
        parts.append(lax.ppermute(
            tile[:bot], axis_name, perm=[(i + 1, i) for i in range(n - 1)]))
    return jnp.concatenate(parts, axis=0) if len(parts) > 1 else tile


def _resize_local_fn(passes_meta, axis_name):
    """Build the per-shard resize body; weight arrays arrive as args."""

    def local_fn(tile, *weights):               # tile uint8[H/n, W, C]
        out = tile
        for (kind, _, top, bot), wt in zip(passes_meta, weights):
            if kind == "h":
                padded = _exchange_rows_asym(out, top, bot, axis_name)
                acc = jnp.einsum(
                    "oh,hwc->owc", wt, padded.astype(jnp.float32),
                    precision=RESIZE_DOT_PRECISION,
                    preferred_element_type=jnp.float32,
                )
            else:
                acc = jnp.einsum(
                    "ow,hwc->hoc", wt, out.astype(jnp.float32),
                    precision=RESIZE_DOT_PRECISION,
                    preferred_element_type=jnp.float32,
                )
            # The reference requantizes to uint8 BETWEEN passes (B6 order).
            out = quantize_u8(acc)
        return out

    return local_fn


def resize_width_spatial(
    img: jnp.ndarray, new_width: int, mesh: Mesh, axis_name: str | None = None
) -> jnp.ndarray:
    """``ops.resize_width`` for ONE giant H-sharded image, halo-exchange form.

    Same math as the single-device op (dense f64-planned weights, matmuls
    at ``RESIZE_DOT_PRECISION``, uint8 requantization between passes, B6
    pass order) — but the H-pass contraction over the sharded dim is resolved by
    a contributions-derived `ppermute` halo exchange instead of GSPMD's
    full-output all-reduce: O(halo*W) bytes/device on the wire instead of
    O(outH*W). Falls back to the GSPMD form when the halo layout cannot
    apply (non-divisible dims or halo deeper than one shard).
    """
    if axis_name is None:
        axis_name = next(iter(mesh.shape))
    height, width = int(img.shape[0]), int(img.shape[1])
    squeeze = img.ndim == 2
    cached = _resize_spatial_cached(height, width, int(new_width), mesh, axis_name)
    if cached is None:
        # GSPMD decides the output layout itself (outH may not divide the
        # mesh — e.g. a truncated B6 height — so it cannot be forced).
        return _gspmd_resize_fn(int(new_width), mesh, axis_name)(img)
    fn, weight_arrays = cached
    img3 = img[:, :, None] if squeeze else img
    out = fn(img3, *weight_arrays)
    return out[:, :, 0] if squeeze else out


@functools.lru_cache(maxsize=32)
def _gspmd_resize_fn(new_width: int, mesh: Mesh, axis_name: str):
    from imageprocessingtools_tpu.ops.resize import resize_width

    sharding = NamedSharding(mesh, P(axis_name))
    return jax.jit(lambda x: resize_width(x, new_width), in_shardings=sharding)


@functools.lru_cache(maxsize=32)
def _resize_spatial_cached(height: int, width: int, new_width: int,
                           mesh: Mesh, axis_name: str):
    """Jitted halo-exchange resize + persistent device weights per geometry.

    Cached so repeat same-shape files (the serve --spatial loop) compile
    once and reuse the already-transferred weight matrices; rebuilding the
    jit wrapper per call would recompile every file. Returns None when the
    halo layout cannot apply.
    """
    n = mesh.shape[axis_name]
    plan = _spatial_resize_plan(height, width, new_width, n)
    if plan is None:
        return None
    sharding = NamedSharding(mesh, P(axis_name))
    _, passes = plan
    passes_meta = tuple((k, None, t, b) for k, _, t, b in passes)

    body = _resize_local_fn(passes_meta, axis_name)
    weight_shardings = tuple(
        NamedSharding(mesh, P(axis_name) if k == "h" else P())
        for k, *_ in passes)
    sharded = shard_map(
        body, mesh=mesh,
        in_specs=(P(axis_name),) + tuple(s.spec for s in weight_shardings),
        out_specs=P(axis_name),
    )
    # Committed once so repeat files reuse the resident weights.
    weight_arrays = tuple(
        jax.device_put(jnp.asarray(w), s)
        for (k, w, *_), s in zip(passes, weight_shardings))
    fn = jax.jit(
        sharded,
        in_shardings=(sharding,) + weight_shardings,
        out_shardings=sharding,
    )
    return fn, weight_arrays


# ---------------------------------------------------------------------------
# Spatial (output-row-sharded) arbitrary-angle ROTATION.
#
# Unlike resize, a rotated output row band's source taps span
# cos*dH + sin*W input rows — at MID angles nearly (or more than) the
# full input height — so a fixed-depth halo exchange is the wrong
# collective there: the right one is a single uint8 all-gather of the
# input, after which each shard runs the blocked rotation
# (`ops.geometry._rotate_apply_blocked`) on ONLY its own output
# row-groups. Per device this moves (n-1)/n * H*W*C uint8 bytes,
# versus GSPMD's all-reduce of the full f32 output (~8x more bytes at
# typical geometries) — and the compute is an even 1/n split of
# row-groups with zero cross-shard math, so the result is bit-identical
# to the single-device op by construction.
#
# At SMALL folded angles, though, sin*W + cos*(outH/n) + taps << H: each
# device's source band spans only m << n input shards, so the round-5
# BAND EXCHANGE ppermutes exactly those m shards (m slot-permutes, window
# assembled per device, block starts rebased into it) instead of
# all-gathering — m/(n-1) of the gather bytes, same bit-identical math.
# The m-shard windows come from the actual plan's per-device sy range on
# host, so reversed/offset group->row maps at any angle are handled; the
# gate `m <= n - 2` keeps the all-gather whenever it moves fewer bytes.
# ---------------------------------------------------------------------------


def rotate_spatial(
    img: jnp.ndarray, angle: float, mesh: Mesh, axis_name: str | None = None
) -> jnp.ndarray:
    """``ops.geometry.rotate`` for ONE giant H-sharded image.

    Exact permutation angles (0/90/180/270) and images too small for the
    blocked plan fall back to the GSPMD-sharded op. Output is H-sharded
    when the padded row-group count divides the mesh; the final crop to
    ``new_h`` rows happens globally.
    """
    from imageprocessingtools_tpu.ops import geometry as _g

    if axis_name is None:
        axis_name = next(iter(mesh.shape))
    n = mesh.shape[axis_name]
    angle = float(angle)
    height, width = int(img.shape[0]), int(img.shape[1])
    plan = None
    if angle not in (0.0, 90.0, 180.0, 270.0) and height % n == 0:
        plan = _g._blocked_plan(height, width, angle)
    if plan is None or n == 1:
        # GSPMD fallback: permutation angles, sub-block images, or an H that
        # cannot be sharded evenly. Keeps whatever sharding the input has.
        return _gspmd_rotate_fn(angle, mesh)(img)

    squeeze = img.ndim == 2
    img3 = img[:, :, None] if squeeze else img
    sharded_fn, plan_arrays, new_h, new_w = _rotate_spatial_cached(
        height, width, angle, mesh, axis_name)
    out = sharded_fn(img3, *plan_arrays)
    out = out[:new_h, :new_w]
    return out[:, :, 0] if squeeze else out


@functools.lru_cache(maxsize=32)
def _gspmd_rotate_fn(angle: float, mesh: Mesh):
    from imageprocessingtools_tpu.ops import geometry as _g

    jitted = jax.jit(lambda x: _g.rotate(x, angle))

    def run(x):
        with mesh:  # GSPMD partitions under the mesh; jit cache persists
            return jitted(x)

    return run


def _band_windows(sy_dev: np.ndarray, bh: int, S: int, n: int):
    """Host plan for the small-angle BAND EXCHANGE, or None for all-gather.

    ``sy_dev`` [n, n_g_loc, n_k]: per-device source block-start rows. Each
    device needs source shards ``starts[d]..starts[d]+m-1`` (m = the
    widest per-device span, window start clamped into range so every slot
    is a real shard). A shard may be wanted by SEVERAL devices (clamping /
    slope < 1) and `lax.ppermute` forbids duplicate sources, so the edge
    set is decomposed into matchings (unique src AND dst per call); the
    receiver places each call's tile at its own per-device window slot via
    `dynamic_update_slice` (slot m is a dummy row-range for calls in which
    a device receives nothing). Returns
    (m, starts, base_rows, matchings, slot_arr); None when the band
    would not move strictly fewer bytes than the (n-1)-shard all-gather.
    """
    s_lo = [int(sy_dev[d].min()) // S for d in range(n)]
    s_hi = [(int(sy_dev[d].max()) + bh - 1) // S for d in range(n)]
    m = max(hi - lo + 1 for lo, hi in zip(s_lo, s_hi))
    while m * S < bh:  # window must hold one source block
        m += 1
    if m > n - 2:  # all-gather moves fewer (or equal) bytes
        return None
    starts = np.array([min(lo, n - m) for lo in s_lo], dtype=np.int32)
    base_rows = (starts * S).astype(np.int32)                # [n]
    edges = [(int(starts[d]) + j, d, j) for d in range(n) for j in range(m)]
    matchings: list[list[tuple[int, int, int]]] = []
    for e in edges:
        for mt in matchings:
            if all(e[0] != x[0] and e[1] != x[1] for x in mt):
                mt.append(e)
                break
        else:
            matchings.append([e])
    slot_arr = np.full((n, len(matchings)), m, dtype=np.int32)
    for c, mt in enumerate(matchings):
        for s, d, j in mt:
            slot_arr[d, c] = j
    # Paranoia: every group's rebased block start must land inside the
    # window with full bh rows (guaranteed by construction; a violation
    # here means a plan bug, so fall back rather than clamp-corrupt).
    reb = sy_dev - base_rows[:, None, None]
    if not bool((reb >= 0).all() and (reb + bh <= m * S).all()):
        return None
    return m, starts, base_rows, matchings, slot_arr


def rotate_band_info(height: int, width: int, angle: float, n: int):
    """Host-only introspection: the band-exchange decision for a geometry.

    Returns None when the geometry has no blocked plan or the all-gather
    is chosen; else a dict with the window width ``m`` (shards ppermuted
    per device), the matching count (ppermute calls per step), and the
    per-device byte ratio vs the all-gather ((n-1) shards)."""
    from imageprocessingtools_tpu.ops import geometry as _g

    if height % n or angle in (0.0, 90.0, 180.0, 270.0):
        return None
    plan = _g._blocked_plan(height, width, float(angle))
    if plan is None:
        return None
    _, _, bh, _, n_g, n_k, _, sy, _, _, _ = plan
    n_g2 = -(-n_g // n) * n
    sy2 = sy.reshape(n_g, n_k)
    if n_g2 != n_g:
        sy2 = np.concatenate(
            [sy2, np.repeat(sy2[-1:], n_g2 - n_g, axis=0)], axis=0)
    S = height // n
    bw_plan = _band_windows(sy2.reshape(n, n_g2 // n, n_k), bh, S, n)
    if bw_plan is None:
        return None
    m, _, _, matchings, _ = bw_plan
    return {
        "m": m,
        "ppermute_calls": len(matchings),
        "bytes_ratio_vs_all_gather": round(m / (n - 1), 3),
    }


@functools.lru_cache(maxsize=32)
def _rotate_spatial_cached(height: int, width: int, angle: float,
                           mesh: Mesh, axis_name: str):
    """Jitted all-gather + row-group-split rotation per geometry.

    Cached like `_resize_spatial_cached`: repeat same-geometry files reuse
    one compile and one set of plan constants.
    """
    from imageprocessingtools_tpu.ops import geometry as _g

    n = mesh.shape[axis_name]
    sharding = NamedSharding(mesh, P(axis_name))
    plan = _g._blocked_plan(height, width, angle)
    new_h, new_w, bh, bw, n_g, n_k, splits, sy, sx, xc, yc = plan
    (axh, axl), (bxh, bxl), (ayh, ayl), (byh, byl) = splits
    G, L = _g._BLOCK_G, _g._BLOCK_L

    # Pad the row-group axis to a mesh multiple by repeating the last
    # group's geometry; padded rows are cropped after the gather-free apply.
    n_g2 = -(-n_g // n) * n
    pad = n_g2 - n_g

    def pad_g(a, group_shape):
        a = a.reshape(n_g, *group_shape)
        if pad:
            a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
        return a

    bxh2, bxl2 = pad_g(bxh, (G,)), pad_g(bxl, (G,))
    byh2, byl2 = pad_g(byh, (G,)), pad_g(byl, (G,))
    sy2, sx2 = pad_g(sy, (n_k,)), pad_g(sx, (n_k,))
    n_g_loc = n_g2 // n

    # Small-folded-angle BAND EXCHANGE: device d's output row-groups read
    # source rows [min(sy_d), max(sy_d)+bh) — at small folded angles that
    # band spans only a few input shards (sin*W + cos*(outH/n) + taps << H),
    # so ppermuting the m needed shards beats all-gathering the whole image
    # ((n-1) shards per device). The per-device shard windows are computed
    # on HOST from the actual plan (handles reversed/offset group->row maps
    # at any angle); the window start is clamped so every slot's source
    # index is in range, making each slot one total ppermute (sources may
    # repeat: XLA collective-permute multicasts; each dest appears once).
    S = height // n
    sy_dev = sy2.reshape(n, n_g_loc, n_k)
    bw_plan = _band_windows(sy_dev, bh, S, n)
    band = bw_plan is not None
    if band:
        m, starts, base_rows, matchings, slot_arr = bw_plan

    if band:

        def body(tile, base_r, slot_r, bxh_l, bxl_l, byh_l, byl_l,
                 sy_l, sx_l, axh_r, axl_r, ayh_r, ayl_r):
            window = jnp.zeros(((m + 1) * S,) + tile.shape[1:], tile.dtype)
            for c, mt in enumerate(matchings):
                recv = lax.ppermute(
                    tile, axis_name, [(s, d) for s, d, _ in mt])
                window = lax.dynamic_update_slice(
                    window, recv, (slot_r[0, c] * S, 0, 0))
            window = window[: m * S]                       # uint8[m*S, W, C]
            return _g._rotate_apply_blocked(
                window, axh_r, axl_r, bxh_l, bxl_l, ayh_r, ayl_r,
                byh_l, byl_l, sy_l, sx_l, xc, yc, base_r[0],
                new_h=n_g_loc * G, new_w=n_k * L, bh=bh, bw=bw,
                n_g=n_g_loc, n_k=n_k,
                zone_hw=(height, width),
            )

        extra_in = (jnp.asarray(base_rows), jnp.asarray(slot_arr))
        extra_specs = (P(axis_name), P(axis_name))
    else:

        def body(tile, bxh_l, bxl_l, byh_l, byl_l, sy_l, sx_l,
                 axh_r, axl_r, ayh_r, ayl_r):
            full = lax.all_gather(tile, axis_name, tiled=True)  # u8[H, W, C]
            return _g._rotate_apply_blocked(
                full, axh_r, axl_r, bxh_l, bxl_l, ayh_r, ayl_r,
                byh_l, byl_l, sy_l, sx_l, xc, yc,
                new_h=n_g_loc * G, new_w=n_k * L, bh=bh, bw=bw,
                n_g=n_g_loc, n_k=n_k,
            )

        extra_in = ()
        extra_specs = ()

    rep = NamedSharding(mesh, P())
    sharded_fn = jax.jit(
        shard_map(
            body, mesh=mesh,
            in_specs=(P(axis_name),) + extra_specs
            + (P(axis_name),) * 6 + (P(),) * 4,
            out_specs=P(axis_name),
        ),
        in_shardings=(sharding,) + (sharding,) * len(extra_specs)
        + (sharding,) * 6 + (rep,) * 4,
    )
    plan_arrays = extra_in + (
        jnp.asarray(bxh2), jnp.asarray(bxl2),
        jnp.asarray(byh2), jnp.asarray(byl2),
        jnp.asarray(sy2), jnp.asarray(sx2),
        jnp.asarray(axh.reshape(n_k, L)), jnp.asarray(axl.reshape(n_k, L)),
        jnp.asarray(ayh.reshape(n_k, L)), jnp.asarray(ayl.reshape(n_k, L)),
    )
    return sharded_fn, plan_arrays, new_h, new_w


# ---------------------------------------------------------------------------
# Spatial PRESET pipelines (models/ surface, H-sharded).
#
# Same halo machinery as the fused pipeline: stencil stages exchange their
# radius in rows (`_exchange_row_halo`), global reductions ride
# `psum`, pointwise stages stay local. The Bayer threshold in print_ready
# depends on the GLOBAL row index, so each shard rebuilds its threshold
# rows from its axis index. Outputs are bit-identical to the unsharded
# preset (thumbnail delegates to the halo-exchange resize and inherits the
# documented +-1-vs-golden budget of the device resize it mirrors).
# ---------------------------------------------------------------------------


def _stencil3_from_padded(padded: jnp.ndarray, h: int, w: int, kernels):
    """Integer 3x3 correlations on a 1-row-halo'd int32 tile; W edges
    replicate locally. Returns one int32[h, w] accumulator per kernel."""
    padded = jnp.pad(padded, ((0, 0), (1, 1)), mode="edge")
    outs = []
    for kern in kernels:
        acc = None
        for dy in range(3):
            for dx in range(3):
                c = kern[dy][dx]
                if c == 0:
                    continue
                tap = padded[dy : dy + h, dx : dx + w]
                term = tap if c == 1 else c * tap
                acc = term if acc is None else acc + term
        outs.append(acc)
    return outs


@functools.lru_cache(maxsize=32)
def _bayer_rows(width: int) -> np.ndarray:
    """int32[4, W]: the Bayer integer thresholds for global rows 0..3."""
    reps = -(-width // 4)
    return np.tile(_exact.BAYER_THRESHOLD_INT, (1, reps))[:, :width]


@functools.lru_cache(maxsize=32)
def _preset_spatial_fn(name: str, height: int, width: int, mesh: Mesh,
                       axis_name: str):
    """One jitted shard_map per (preset, shape, mesh) — the serve --spatial
    loop reuses the compile across same-shape files."""
    from imageprocessingtools_tpu.ops.stencil import _isqrt_round

    n_pixels = height * width
    local_h = height // mesh.shape[axis_name]
    bayer = jnp.asarray(_bayer_rows(width)) if name == "print_ready" else None

    def local_fn(tile):  # uint8[H/n, W, 3]
        g = grayscale(tile)
        if name == "edge_detect":
            padded = _exchange_row_halo(g.astype(jnp.int32), 2, axis_name)
            blurred = _gaussian5_from_padded(padded, local_h, width)
            p1 = _exchange_row_halo(blurred.astype(jnp.int32), 1, axis_name)
            gx, gy = _stencil3_from_padded(
                p1, local_h, width,
                (((-1, 0, 1), (-2, 0, 2), (-1, 0, 1)),
                 ((-1, -2, -1), (0, 0, 0), (1, 2, 1))),
            )
            k = _isqrt_round(gx * gx + gy * gy)
            return jnp.clip(k, 0, 255).astype(jnp.uint8)
        if name == "enhance":
            hist = lax.psum(histogram(g), axis_name)
            eq = apply_lut(g, _equalize_lut(hist, n_pixels))
            p1 = _exchange_row_halo(eq.astype(jnp.int32), 1, axis_name)
            (s,) = _stencil3_from_padded(
                p1, local_h, width, (((0, -1, 0), (-1, 5, -1), (0, -1, 0)),)
            )
            return jnp.clip(s, 0, 255).astype(jnp.uint8)
        if name == "print_ready":
            hist = lax.psum(histogram(g), axis_name)
            eq = apply_lut(g, _equalize_lut(hist, n_pixels))
            # Bayer threshold by GLOBAL row: this shard starts at row
            # idx*local_h; gather its h rows from the 4-row pattern.
            start = lax.axis_index(axis_name) * local_h
            rows = (start + jnp.arange(local_h)) % 4
            thr = bayer[rows]
            # rgb-broadcast + (r+g+b)//3 of eq is eq itself, so the dither
            # compares eq directly (bit-identical to the batch preset).
            return (eq < thr).astype(jnp.uint8)
        raise ValueError(f"unknown spatial preset {name!r}")

    sharding = NamedSharding(mesh, P(axis_name))
    return jax.jit(
        shard_map(local_fn, mesh=mesh, in_specs=P(axis_name),
                  out_specs=P(axis_name)),
        in_shardings=sharding,
        out_shardings=sharding,
    )


def preset_pipeline_spatial(
    img: jnp.ndarray, name: str, mesh: Mesh, axis_name: str | None = None
) -> jnp.ndarray:
    """A models/ preset over ONE giant uint8[H, W, 3] image, H-sharded.

    edge_detect / enhance / print_ready run as explicit shard_map pipelines
    (ppermute stencil halos, psum histogram) bit-identical to the unsharded
    preset; thumbnail rides the contributions-derived halo-exchange resize.
    H must divide the mesh axis with >= 2 rows per shard (callers reduce to
    a divisor submesh, as serve --spatial does).
    """
    if axis_name is None:
        axis_name = next(iter(mesh.shape))
    if name == "thumbnail":
        return resize_width_spatial(img, 256, mesh, axis_name)
    height, width = int(img.shape[0]), int(img.shape[1])
    n = mesh.shape[axis_name]
    if height % n != 0 or height // n < 2:
        raise ValueError(
            f"H={height} must be divisible by {axis_name}={n} with >=2 rows/shard"
        )
    return _preset_spatial_fn(name, height, width, mesh, axis_name)(img)
