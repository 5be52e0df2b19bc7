"""Batched end-to-end serving: files -> decode -> device pipeline -> encode.

The reference is one image per process (decode, op chain, encode,
``ppmx-edward.c:1053-1172``). This module amortizes codec and device work
over many files: native C++ parallel decode into one contiguous batch,
shape-bucketing (XLA needs static shapes — one compile per bucket, survey
§7.7), a vmapped jitted pipeline optionally sharded over a device mesh, and
parallel host encode (P4 bit packing happens on device).
"""

from __future__ import annotations

import collections
import functools
import queue
import threading

import jax
import numpy as np

from imageprocessingtools_tpu.codec import native, ppm
from imageprocessingtools_tpu.ops.packing import pack_bits_device
from imageprocessingtools_tpu.pipeline import PipelineConfig, run_pipeline
from imageprocessingtools_tpu.codec.ppm import FILETYPE_PBM


@functools.lru_cache(maxsize=64)
def _pipeline_fn(config: PipelineConfig):
    """One stable callable per config so jit caches hit across chunks
    (PipelineConfig is a frozen dataclass, hence hashable)."""

    def one(img):
        out, _ = run_pipeline(img, config)
        if config.mono:
            out = pack_bits_device(out)  # device-side P4 packing
        return out

    return one


@functools.lru_cache(maxsize=64)
def _preset_pipeline_fn(name: str):
    """(traceable single-image fn, file_type) for a models/ preset name.

    PBM presets pack bits on device like the reference mono path. Cached so
    jit caches key on a stable callable per name (as `_pipeline_fn` does
    per config)."""
    from imageprocessingtools_tpu.models import PRESET_FILE_TYPES, get_preset

    fn = get_preset(name)  # raises ValueError for unknown names
    file_type = PRESET_FILE_TYPES[name]

    def one(img):
        out = fn(img)
        if file_type == FILETYPE_PBM:
            out = pack_bits_device(out)
        return out

    return one, file_type


def config_tag(item) -> str:
    """Stable output-name tag for one fan-out element: the preset name for
    a string, or the reference flags in fixed pipeline order for a
    `PipelineConfig` (e.g. ``PipelineConfig(new_width=1920, gray=True)`` ->
    ``"w1920-gray"``). Fan-out outputs are written to
    ``<path>.<tag><suffix>``."""
    if isinstance(item, str):
        return item
    parts = []
    if item.new_width is not None:
        parts.append(f"w{int(item.new_width)}")
    if item.angle is not None:
        a = float(item.angle)
        parts.append(f"r{int(a)}" if a.is_integer() else f"r{a}")
    if item.gray:
        parts.append("gray")
    if item.mono:
        parts.append("mono")
    if item.flip_v:
        parts.append("fv")
    if item.flip_h:
        parts.append("fh")
    if not parts:  # quirk B2: the reference requires at least one op
        raise ValueError("Error: no data to write\n")
    return "-".join(parts)


@functools.lru_cache(maxsize=32)
def _fanout_pipeline_fn(items: tuple):
    """(single-image fn returning one output PER element, file_types tuple)
    for a tuple of preset names and/or `PipelineConfig`s — FAN-OUT serving.

    One traced function means ONE device dispatch per chunk: the uint8
    batch is decoded, transferred, and read from device memory once, and
    every element's compute shares it (the gain over N single-config
    passes is not measured on the GPU). XLA additionally CSEs shared
    prefixes (edge_detect /
    enhance / print_ready all start with the same grayscale; reference
    configs sharing a resize target share the weight matmuls)."""
    if not items:
        raise ValueError("empty fan-out list")
    tags = [config_tag(it) for it in items]  # validates B2 per element
    if len(set(tags)) != len(tags):
        raise ValueError(f"duplicate fan-out outputs: {sorted(tags)}")
    parts = [
        _preset_pipeline_fn(it) if isinstance(it, str)
        else (_pipeline_fn(it), it.file_type)
        for it in items  # _preset_pipeline_fn validates each name
    ]
    fns = tuple(p[0] for p in parts)
    file_types = tuple(p[1] for p in parts)

    def one(img):
        return tuple(fn(img) for fn in fns)

    return one, file_types


def _task_fn(config) -> tuple:
    """(single-image fn, file_type) for a PipelineConfig, preset name, or
    tuple of preset names / PipelineConfigs (fan-out; file_type is then a
    tuple too)."""
    if isinstance(config, tuple):
        return _fanout_pipeline_fn(config)
    if isinstance(config, str):
        return _preset_pipeline_fn(config)
    return _pipeline_fn(config), config.file_type


def _task_unpacked_shape(config, h: int, w: int) -> tuple:
    """Pre-P4-packing output shape for one (h, w, 3) input (the P4 writer
    needs the real width; device packing pads rows to byte boundaries)."""
    if isinstance(config, str):
        from imageprocessingtools_tpu.models import get_preset

        raw = get_preset(config)
        return jax.eval_shape(raw, jax.ShapeDtypeStruct((h, w, 3), np.uint8)).shape
    return jax.eval_shape(
        lambda im: run_pipeline(im, config)[0],
        jax.ShapeDtypeStruct((h, w, 3), np.uint8),
    ).shape


@functools.lru_cache(maxsize=64)
def _jitted_local_vmap(fn):
    return jax.jit(jax.vmap(fn))


@functools.lru_cache(maxsize=64)
def _jitted_single(fn, sharding=None):
    """Stable jit wrapper per (fn, sharding): a fresh jax.jit(fn) per call
    owns a fresh compile cache, so repeat same-shape files would recompile."""
    if sharding is None:
        return jax.jit(fn)
    return jax.jit(fn, in_shardings=sharding)


def process_batch(images: np.ndarray, config: PipelineConfig | str | tuple,
                  mesh=None):
    """uint8[N, H, W, 3] -> (uint8[N, ...], file_type), vmapped + jitted.

    ``config`` is a PipelineConfig (reference ops), a preset name from
    `models.PRESETS` (extension pipelines; P4 presets pack bits on device),
    or a tuple of preset names and/or PipelineConfigs (fan-out: returns a
    tuple of outputs and a tuple of file_types from ONE device dispatch
    over the shared batch).
    With a mesh, the batch axis is sharded; a batch that does not divide the
    mesh size is padded (repeating the last image) up to the next multiple
    and the padding sliced off the result, so remainder chunks work.
    Compiles once per (config, input shape); repeat chunks reuse the cache.
    """
    one, file_type = _task_fn(config)
    if mesh is not None:
        from imageprocessingtools_tpu.parallel.batch import batch_apply

        n = images.shape[0]
        n_dev = int(np.prod(list(mesh.shape.values())))
        pad = (-n) % n_dev
        if pad:
            images = np.concatenate(
                [images, np.repeat(images[-1:], pad, axis=0)], axis=0
            )
        out = batch_apply(one, images, mesh=mesh)
        if pad:
            # tree.map so fan-out tuples slice each PRESET's batch axis
            # (a bare out[:n] would slice the tuple of presets instead).
            out = jax.tree.map(lambda o: o[:n], out)
    else:
        out = _jitted_local_vmap(one)(images)
    return out, file_type


def process_file_spatial(
    path: str,
    config: PipelineConfig | str,
    mesh=None,
    suffix: str = ".out",
) -> str:
    """ONE giant image, H-sharded over the mesh (spatial parallelism).

    The image analog of sequence/context parallelism: rows are split over
    devices. ``config`` is a PipelineConfig (reference ops — the
    sharded jit lets GSPMD insert the collectives: flips become permutes,
    the resize H-pass a sharded matmul), the string ``"fused"`` for the
    gray -> 5x5 Gaussian -> hist-eq extension pipeline, or a models/ preset
    name — both strings use the explicit shard_map + ppermute halo-exchange
    paths (parallel/spatial.fused_pipeline_spatial /
    preset_pipeline_spatial). If H is not divisible by the mesh size, the
    largest divisor-sized submesh is used (1 device worst case). Writes
    ``<path><suffix>``; returns the output path.
    """
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from imageprocessingtools_tpu.parallel.batch import default_mesh
    from imageprocessingtools_tpu.parallel.spatial import fused_pipeline_spatial

    if mesh is None:
        mesh = default_mesh()
    axis = next(iter(mesh.shape))
    with open(path, "rb") as f:
        img, maxval = ppm.decode_ppm(f.read())

    n = mesh.shape[axis]
    n_use = next((d for d in range(n, 0, -1)
                  if img.shape[0] % d == 0 and img.shape[0] // d >= 2), 1)
    if n_use != n:
        mesh = Mesh(np.asarray(mesh.devices).reshape(-1)[:n_use], (axis,))
    sharding = NamedSharding(mesh, P(axis))
    # The host uint8 array goes straight to jitted callees, whose
    # in_shardings place it on the mesh.
    img_d = img

    out_path = path + suffix
    if config == "fused":
        if n_use == 1:
            # Degenerate shard (e.g. a 1-row image): the halo-exchange path
            # needs >= 2 rows/shard; the single-device pipeline is identical
            # (the JITTED alias — the bare fn would dispatch each op
            # eagerly).
            from imageprocessingtools_tpu.kernels.fused import fused_gray_gauss_histeq

            out = fused_gray_gauss_histeq(img_d)
        else:
            out = fused_pipeline_spatial(img_d, mesh, axis_name=axis)
        ppm.write_ppm(out_path, np.asarray(out), file_type=ppm.FILETYPE_PGM,
                      max_color=maxval)
        return out_path

    if isinstance(config, str):
        # models/ preset, H-sharded. The degenerate 1-shard case runs the
        # jitted batch preset fn (identical result, no shard_map overhead).
        from imageprocessingtools_tpu.models import PRESET_FILE_TYPES
        from imageprocessingtools_tpu.parallel.spatial import (
            preset_pipeline_spatial,
        )

        if config not in PRESET_FILE_TYPES:
            raise ValueError(
                f"unknown preset {config!r}; available: "
                f"{sorted(PRESET_FILE_TYPES)}"
            )
        file_type = PRESET_FILE_TYPES[config]
        if n_use == 1:
            one, _ = _task_fn(config)  # includes device P4 packing
            out_np = np.asarray(_jitted_single(one)(img_d))
        else:
            out = preset_pipeline_spatial(img_d, config, mesh, axis_name=axis)
            out_np = np.asarray(out)
            if file_type == FILETYPE_PBM:
                out_np = np.packbits(out_np, axis=1)
        if file_type == FILETYPE_PBM:
            unpacked = _task_unpacked_shape(config, img.shape[0], img.shape[1])
            _write_p4(out_path, out_np, unpacked[0], unpacked[1])
        else:
            ppm.write_ppm(out_path, out_np, file_type=file_type,
                          max_color=maxval)
        return out_path

    if config.angle is not None and _bucket_needs_strict_rotation(
            img.shape[0], img.shape[1], config):
        # Same guard as process_files' buckets: a geometry flagged by the
        # double-f32 zone audit must take the bit-exact host path (no known
        # case reaches here — the 359-angle sweep is clean — but giant-image
        # geometries are exactly the ones outside the committed sweep grid).
        res, ft = run_pipeline(img, config, strict_rotation=True)
        res_np = np.asarray(res)
        if ft == FILETYPE_PBM:
            _write_p4(out_path, np.packbits(res_np, axis=1),
                      res_np.shape[0], res_np.shape[1])
        else:
            ppm.write_ppm(out_path, res_np, file_type=ft, max_color=maxval)
        return out_path

    if n_use > 1 and (config.new_width is not None or config.angle is not None):
        # Resample stages via the explicit spatial-parallel paths — resize
        # through the halo-exchange shard_map (ppermute of contributions-
        # derived halo rows), rotation through the all-gathered row-group
        # split — then the remaining elementwise ops under GSPMD.
        import dataclasses

        from imageprocessingtools_tpu.parallel.spatial import (
            resize_width_spatial,
            rotate_spatial,
        )

        if config.new_width is not None:
            img_d = resize_width_spatial(img_d, int(config.new_width), mesh)
        if config.angle is not None:
            img_d = rotate_spatial(img_d, float(config.angle), mesh)
        rest = dataclasses.replace(config, new_width=None, angle=None)
        if rest.any_op:  # covers mono (P4 packing happens in _pipeline_fn)
            out = _jitted_single(_pipeline_fn(rest))(img_d)
        else:
            out = img_d
    else:
        out = _jitted_single(_pipeline_fn(config), sharding)(img_d)
    out_np = np.asarray(out)
    if config.file_type == FILETYPE_PBM:
        unpacked = jax.eval_shape(
            lambda im: run_pipeline(im, config)[0],
            jax.ShapeDtypeStruct(img.shape, np.uint8),
        ).shape
        _write_p4(out_path, out_np, unpacked[0], unpacked[1])
    else:
        ppm.write_ppm(out_path, out_np, file_type=config.file_type,
                      max_color=maxval)
    return out_path


def _write_p4(out_path: str, packed_rows: np.ndarray, height: int,
              width: int) -> None:
    """Write a P4 whose payload rows are already device-packed bytes."""
    header = b"P4\n" + ppm.GENERATED_COMMENT + b"%d %d\n" % (width, height)
    with open(out_path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(packed_rows).data)


def _encode_chunk(idxs, out_np, file_type, unpacked, paths, metas, suffix,
                  out_paths, names=None) -> None:
    """Host-encode one processed chunk to ``<path><suffix>`` files via the
    threaded native batch encoder (``native.encode_batch_files`` — the
    reference encoder at ``ppmx-edward.c:221-301`` is 1 byte/fwrite, one
    image/process); for fan-out (``names`` given) to
    ``<path>.<preset><suffix>`` per preset."""
    if names is not None:
        for k, name in enumerate(names):
            files = [paths[i] + "." + name + suffix for i in idxs]
            native.encode_batch_files(
                files, out_np[k], file_type[k],
                [metas[i][2] for i in idxs],
                p4_dims=unpacked[k] if file_type[k] == FILETYPE_PBM else None,
            )
            for j, i in enumerate(idxs):
                out_paths[i][k] = files[j]
        return
    files = [paths[i] + suffix for i in idxs]
    native.encode_batch_files(
        files, out_np, file_type,
        [metas[i][2] for i in idxs],
        p4_dims=unpacked if file_type == FILETYPE_PBM else None,
    )
    for j, i in enumerate(idxs):
        out_paths[i] = files[j]


def _to_host(out):
    """Transfer device output(s) to host (waits for the device); fan-out
    outputs are a tuple of arrays."""
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _read_and_decode(paths, idxs, expected_hw, on_error="raise",
                     failures=None):
    """Batch-decode one chunk of files straight into a contiguous tensor
    (``native.decode_batch_files``: payloads pread() into their batch rows —
    one page-cache->tensor copy, no per-file Python ``bytes``). With
    ``on_error="skip"``, a file that fails to open or decode is dropped from
    the chunk (its message recorded in ``failures[i]``); the per-file rc
    surface of the native decoder isolates the bad file without a re-decode
    pass. Returns (kept_idxs, batch); batch is None when nothing survived."""
    h, w = expected_hw
    batch, errs = native.decode_batch_files([paths[i] for i in idxs], h, w)
    if not errs:
        return list(idxs), batch
    if on_error != "skip":
        kind, msg = errs[min(errs)]
        if kind == "open":
            # Preserve the historical surface: an unreadable file raised the
            # builtin OSError from open() on this path.
            with open(paths[idxs[min(errs)]], "rb"):
                pass
            raise OSError(msg)  # opened on retry (race) — still fail fast
        raise ppm.PPMError(msg)
    for j, (_, msg) in errs.items():
        failures[idxs[j]] = msg
    kept = [i for j, i in enumerate(idxs) if j not in errs]
    if not kept:
        return [], None
    return kept, batch[np.array([j for j in range(len(idxs)) if j not in errs])]


def _bucket_needs_strict_rotation(h: int, w: int, config: PipelineConfig) -> bool:
    """True if this bucket's ROTATED geometry fails the double-f32 zone
    audit (`ops.geometry.rotation_decisions_safe`) and must take the
    bit-exact host path. Cached per geometry inside the audit."""
    if config.angle is None or float(config.angle) in (0.0, 90.0, 180.0, 270.0):
        return False
    gh, gw = h, w
    if config.new_width is not None:
        from imageprocessingtools_tpu.ops import _exact

        plan = _exact.plan_resize(h, w, int(config.new_width))
        gh, gw = plan.new_height, plan.new_width
    from imageprocessingtools_tpu.ops.geometry import rotation_decisions_safe

    return not rotation_decisions_safe(gh, gw, float(config.angle))


def process_files(
    paths: list[str],
    config: PipelineConfig | str | tuple | list,
    mesh=None,
    suffix: str = ".out",
    max_batch: int = 256,
    overlap: bool = True,
    on_error: str = "raise",
    failures: dict | None = None,
) -> list[str]:
    """Run the pipeline over many files; writes ``<path>.out``.

    ``config`` is a PipelineConfig (the reference's six-flag pipeline), a
    preset name from `models.PRESETS` (extension pipelines served with the
    same bucketing/overlap machinery), or a tuple/list of preset names
    and/or PipelineConfigs — FAN-OUT: every element runs in one device
    dispatch per chunk, so the decode and the host->device upload are paid
    once for N outputs.
    Fan-out writes ``<path>.<tag><suffix>`` per element (`config_tag`:
    the preset name, or the reference flags like ``w1920-gray``) and
    returns a list of per-input path lists instead of a flat path list.

    Files are bucketed by (H, W) so each unique shape compiles once; each
    bucket is decoded with the native batched codec and processed on device
    in vmapped dispatches of at most ``max_batch`` images (bounding host
    and device memory for e.g. 4096-file runs), then encoded on host.

    With ``overlap=True`` the three stages run pipelined: a reader thread
    decodes chunk N+1 and a writer thread encodes chunk N-1 while the device
    processes chunk N (the reference is strictly serial decode->op->encode,
    ``ppmx-edward.c:1053-1172``). Queues are bounded to 2 chunks so host
    memory stays ~5 chunks regardless of file count. Returns output paths.

    ``on_error="skip"``: a file that fails to open, parse, or decode is
    skipped (its input path -> stdout-style message recorded in the
    caller-supplied ``failures`` dict) and the rest of the run proceeds —
    one corrupt file must not sink a 4096-file campaign. The default
    ``"raise"`` keeps the reference's fail-fast semantics. A skipped file
    inside a chunk shrinks that chunk's batch (one extra compile for the
    odd size — rare-path cost only).
    """
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip', got {on_error!r}")
    path_failures: dict = {} if failures is None else failures
    # First pass: headers only — reads a 64 KB prefix + stat per file (NOT
    # the payload) through the NATIVE lexer (identical grammar/messages;
    # transparently falls back to the Python codec without a toolchain);
    # payloads are read per chunk so host memory stays bounded by a few
    # chunks, not the whole file set.
    fanout_names: tuple | None = None
    fanout_tags: tuple | None = None
    if isinstance(config, (tuple, list)):
        fanout_names = tuple(config)
        config = fanout_names
        _fanout_pipeline_fn(fanout_names)  # validate elements early
        fanout_tags = tuple(config_tag(x) for x in fanout_names)

    idx_failures: dict[int, str] = {}
    metas = []
    for i, p in enumerate(paths):
        try:
            w, h, maxval, _ = native.parse_file_header(p)
        except (ppm.PPMError, OSError) as e:
            if on_error != "skip":
                raise
            idx_failures[i] = (
                e.message if isinstance(e, ppm.PPMError)
                else "error. can not open file\n"
            )
            metas.append(None)
            continue
        metas.append((h, w, maxval))

    buckets: dict[tuple[int, int], list[int]] = collections.defaultdict(list)
    for i, m in enumerate(metas):
        if m is not None:
            buckets[(m[0], m[1])].append(i)

    out_paths: list = (
        [[None] * len(fanout_names) for _ in paths]
        if fanout_names is not None else [None] * len(paths)
    )
    for (h, w), all_idxs in buckets.items():
        if isinstance(config, PipelineConfig) and _bucket_needs_strict_rotation(
                h, w, config):
            # The double-f32 zone audit flagged this geometry (no known
            # case reaches here — the committed 359-angle sweep is clean —
            # but the vmapped pipeline cannot take the bit-exact host
            # fallback under tracing, so the bucket runs eagerly).
            for i in all_idxs:
                try:
                    with open(paths[i], "rb") as f:
                        img, _ = ppm.decode_ppm(f.read())
                except (ppm.PPMError, OSError) as e:
                    if on_error != "skip":
                        raise
                    idx_failures[i] = (
                        e.message if isinstance(e, ppm.PPMError)
                        else "error. can not open file\n"
                    )
                    continue
                res, ft = run_pipeline(img, config, strict_rotation=True)
                res_np = np.asarray(res)
                out_path = paths[i] + suffix
                if ft == FILETYPE_PBM:
                    _write_p4(out_path, np.packbits(res_np, axis=1),
                              res_np.shape[0], res_np.shape[1])
                else:
                    ppm.write_ppm(out_path, res_np, file_type=ft,
                                  max_color=metas[i][2])
                out_paths[i] = out_path
            continue
        if fanout_names is not None and any(
            isinstance(c, PipelineConfig)
            and _bucket_needs_strict_rotation(h, w, c)
            for c in fanout_names
        ):
            # Same audit guard as the single-config bucket above, for a
            # fan-out tuple containing a flagged rotation geometry: the
            # whole bucket runs eagerly per file, flagged configs through
            # the bit-exact host path, the rest through the jitted single
            # fn (rare safety path — the committed angle sweep is clean).
            for i in all_idxs:
                try:
                    with open(paths[i], "rb") as f:
                        img, _ = ppm.decode_ppm(f.read())
                except (ppm.PPMError, OSError) as e:
                    if on_error != "skip":
                        raise
                    idx_failures[i] = (
                        e.message if isinstance(e, ppm.PPMError)
                        else "error. can not open file\n"
                    )
                    continue
                for k, c in enumerate(fanout_names):
                    if isinstance(c, PipelineConfig):
                        res, ft = run_pipeline(img, c, strict_rotation=True)
                        res_np = np.asarray(res)
                    else:
                        one, ft = _preset_pipeline_fn(c)
                        res_np = np.asarray(_jitted_single(one)(img))
                    out_path = paths[i] + "." + fanout_tags[k] + suffix
                    if ft == FILETYPE_PBM:
                        if isinstance(c, PipelineConfig):
                            # preset fns pack bits on device; the host
                            # run_pipeline result is still unpacked
                            res_np = np.packbits(res_np, axis=1)
                        dims = _task_unpacked_shape(c, h, w)
                        _write_p4(out_path, res_np, dims[0], dims[1])
                    else:
                        ppm.write_ppm(out_path, res_np, file_type=ft,
                                      max_color=metas[i][2])
                    out_paths[i][k] = out_path
            continue
        # Pre-pack spatial dims (resize/rotate may change them before mono).
        if fanout_names is not None:
            unpacked: tuple = tuple(
                _task_unpacked_shape(n, h, w) for n in fanout_names
            )
        else:
            unpacked = _task_unpacked_shape(config, h, w)
        chunks = [
            all_idxs[k : k + max_batch]
            for k in range(0, len(all_idxs), max_batch)
        ]
        if not overlap or len(chunks) == 1:
            for idxs in chunks:
                kept, batch = _read_and_decode(
                    paths, idxs, (h, w), on_error, idx_failures)
                if not kept:
                    continue
                out, file_type = process_batch(batch, config, mesh=mesh)
                _encode_chunk(kept, _to_host(out), file_type, unpacked,
                              paths, metas, suffix, out_paths,
                              names=fanout_tags)
            continue

        decode_q: queue.Queue = queue.Queue(maxsize=2)
        encode_q: queue.Queue = queue.Queue(maxsize=2)
        errors: list[BaseException] = []

        def reader():
            try:
                for idxs in chunks:
                    if errors:
                        return
                    kept, batch = _read_and_decode(
                        paths, idxs, (h, w), on_error, idx_failures)
                    if kept:
                        decode_q.put((kept, batch))
            except BaseException as e:  # surfaced in the main thread
                errors.append(e)
            finally:
                decode_q.put(None)

        def writer():
            try:
                while True:
                    item = encode_q.get()
                    if item is None:
                        return
                    _encode_chunk(*item, paths, metas, suffix, out_paths,
                                  names=fanout_tags)
            except BaseException as e:
                errors.append(e)

        rt = threading.Thread(target=reader, daemon=True)
        wt = threading.Thread(target=writer, daemon=True)
        rt.start()
        wt.start()

        def put_to_writer(item) -> bool:
            # Bounded put that cannot deadlock on a dead writer: if the
            # writer raised (e.g. disk full in _encode_chunk), its queue
            # stops draining and a plain put() would block forever.
            while wt.is_alive() and not errors:
                try:
                    encode_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            while True:
                item = decode_q.get()
                if item is None:
                    break
                idxs, batch = item
                out, file_type = process_batch(batch, config, mesh=mesh)
                # _to_host waits for the device; the reader keeps decoding
                # meanwhile.
                if not put_to_writer((idxs, _to_host(out), file_type, unpacked)):
                    break
        except BaseException as e:
            errors.append(e)
        finally:
            # Deliver the writer sentinel. Happy path: the writer is
            # draining, so the timed put succeeds. Error path: drop queued
            # chunks to make room (we are about to raise anyway).
            while wt.is_alive():
                try:
                    encode_q.put(None, timeout=0.1)
                    break
                except queue.Full:
                    if errors:
                        try:
                            encode_q.get_nowait()
                        except queue.Empty:
                            pass
            # Drain so a reader blocked on a full queue can reach its
            # sentinel and exit (otherwise join() deadlocks on early error).
            while rt.is_alive():
                try:
                    decode_q.get_nowait()
                except queue.Empty:
                    rt.join(timeout=0.05)
            rt.join()
            wt.join()
        if errors:
            raise errors[0]
    for i, msg in idx_failures.items():
        path_failures[paths[i]] = msg
    if fanout_names is not None:
        return [o for i, o in enumerate(out_paths) if i not in idx_failures]
    return [p for p in out_paths if p is not None]
