"""Randomized differential fuzz of the SERVING layer vs the single-image CLI.

Each round builds a random file SET (mixed shape buckets, random sizes and
contents, optionally corrupt/missing files), picks a random task (reference
flag combo via the CLI-campaign generator, a preset, or a fan-out preset
tuple) and random machinery knobs (max_batch so multi-chunk paths run,
overlap on/off), then runs `serving.process_files` and checks EVERY output
against the single-image path for the same file:

  - reference exact combos: byte-identical to `cli.main` output;
  - reference float combos (resize / arbitrary rotation): identical header,
    payload within the documented +-1 budget (P4 float combos are skipped,
    same rule as the CLI campaign — a +-1 gray diff may flip a dither bit);
  - presets: byte-identical to a fresh single-file `process_files` run
    (and, for fan-out, across every preset in the tuple);
  - corrupt/missing files: recorded in `failures` with the single-image
    message, never produce an output, and never affect neighbours;
  - a resume round: delete a random subset of outputs, re-run through the
    serve CLI with --resume, and require exactly the deleted ones redone.

SPATIAL rounds (`run_spatial_round`): every 4th
round (or all of them with --spatial) drives `serve --spatial` /
`process_file_spatial` over random giant-ish shapes — H not divisible by
the mesh (divisor-submesh fallback), spatial presets incl. the P4 one,
reference configs biased toward resample stages (halo resize, band-
exchange/all-gather rotation), the "fused" pipeline, and a skip-bad
probe — each output differentially checked against the single-device
path.

    python tools/serving_fuzz.py [n_rounds] [seed_base] [--spatial] > report.json
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))  # fuzz_campaign

# CPU campaign tool — but tests import run_round too, and a GPU suite run
# (JAX_PLATFORMS=cuda) must keep whatever backend the conftest chose.
if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        # 8 virtual devices so the mesh-sharded rounds actually shard
        # (standalone runs; under pytest the conftest already sets this).
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from imageprocessingtools_tpu import cli, serve, serving  # noqa: E402
from imageprocessingtools_tpu.codec import ppm  # noqa: E402
from imageprocessingtools_tpu.models import PRESETS  # noqa: E402
from imageprocessingtools_tpu.pipeline import PipelineConfig  # noqa: E402

from fuzz_campaign import _has_float_op, _random_args  # noqa: E402

PRESET_NAMES = sorted(PRESETS)


def _compare_pm1(got: bytes, exp: bytes) -> str | None:
    """None if payloads match within +-1 under identical headers."""
    hg, pg = got.split(b"\n", 3)[:3], got.split(b"\n", 3)[3]
    he, pe = exp.split(b"\n", 3)[:3], exp.split(b"\n", 3)[3]
    if hg != he:
        return "header differs"
    a = np.frombuffer(pg, np.uint8).astype(np.int16)
    b = np.frombuffer(pe, np.uint8).astype(np.int16)
    if a.shape != b.shape:
        return "payload size differs"
    if np.abs(a - b).max() > 1:
        return f"payload exceeds +-1 (max {np.abs(a - b).max()})"
    return None


def run_round(seed: int, workdir: str) -> tuple[dict, list[str]]:
    rng = np.random.default_rng(seed)
    fails: list[str] = []
    rec: dict = {"seed": seed}

    # --- file set: 2-3 shape buckets, 4-10 files each.
    shapes = []
    for _ in range(int(rng.integers(2, 4))):
        h = int(rng.integers(6, 48))
        w = int(rng.integers(6, 48))
        shapes += [(h, w)] * int(rng.integers(4, 11))
    rng.shuffle(shapes)
    paths, imgs = [], []
    for i, (h, w) in enumerate(shapes):
        p = os.path.join(workdir, f"s{seed}_f{i}.ppm")
        img = np.random.default_rng(seed ^ (7919 * i + 13)).integers(
            0, 256, (h, w, 3), dtype=np.uint8)
        ppm.write_ppm(p, img)
        paths.append(p)
        imgs.append(img)
    rec["n_files"] = len(paths)

    # --- corrupt a subset (skip-bad coverage).
    n_bad = int(rng.integers(0, 3))
    bad: dict[str, str] = {}
    bad_idx = rng.choice(len(paths), size=n_bad, replace=False) if n_bad else []
    for i in bad_idx:
        kind = int(rng.integers(0, 3))
        if kind == 0:
            os.remove(paths[i])
            bad[paths[i]] = "missing"
        elif kind == 1:
            data = open(paths[i], "rb").read()
            with open(paths[i], "wb") as f:
                f.write(data[: max(8, len(data) - int(rng.integers(1, 40)))])
            bad[paths[i]] = "truncated"
        else:
            with open(paths[i], "wb") as f:
                f.write(b"P5 1 1 255 x")
            bad[paths[i]] = "wrong_magic"
    rec["n_bad"] = n_bad

    # --- task + machinery knobs.
    task_kind = int(rng.integers(0, 3))
    max_batch = int(rng.integers(2, 7))  # force multi-chunk paths
    overlap = bool(rng.integers(0, 2))
    mesh = None
    if rng.random() < 0.34:
        # Shard ~1/3 of rounds over the local mesh (8 virtual CPU devices
        # in CI; chunk sizes 2-6 vs 8 devices also fuzz the pad/slice
        # remainder path on every chunk).
        import jax as _jax

        from imageprocessingtools_tpu.parallel.batch import default_mesh

        if len(_jax.devices()) > 1:
            mesh = default_mesh()
    rec.update(max_batch=max_batch, overlap=overlap, mesh=mesh is not None)
    if task_kind == 0:
        args = _random_args(rng, shapes[0][1])
        # B9/B7 domains are the CLI campaign's job; keep widths sane here.
        args = [a for a in args if not (a.startswith("-w")
                                        and int(a[2:]) > 4 * shapes[0][1])]
        if not args:
            args = ["-gray"]
        config, _ = cli._parse_args(args + [paths[0]])
        rec["task"] = args
        rec["kind"] = "reference"
    elif task_kind == 1:
        name = PRESET_NAMES[int(rng.integers(0, len(PRESET_NAMES)))]
        config = name
        rec["task"] = name
        rec["kind"] = "preset"
    else:
        k = int(rng.integers(2, len(PRESET_NAMES) + 1))
        names = tuple(np.asarray(PRESET_NAMES)[
            rng.choice(len(PRESET_NAMES), size=k, replace=False)])
        config = tuple(str(n) for n in names)
        rec["task"] = list(config)
        rec["kind"] = "fanout"

    failures: dict = {}
    outs = serving.process_files(
        paths, config, suffix=".srv", max_batch=max_batch, overlap=overlap,
        mesh=mesh, on_error="skip", failures=failures)

    # --- corrupt files: recorded, no output, correct count.
    if set(failures) != set(bad):
        fails.append(f"failures {sorted(failures)} != corrupt {sorted(bad)}")
    for p in bad:
        if isinstance(config, tuple):
            leaked = [p + "." + n + ".srv" for n in config
                      if os.path.exists(p + "." + n + ".srv")]
        else:
            leaked = [p + ".srv"] if os.path.exists(p + ".srv") else []
        if leaked:
            fails.append(f"corrupt file produced outputs: {leaked}")

    good = [p for p in paths if p not in bad]
    if len(outs) != len(good):
        fails.append(f"{len(outs)} outputs for {len(good)} good files")

    # --- differential: serving output vs the single-image path per file.
    is_float = isinstance(config, PipelineConfig) and _has_float_op(
        rec["task"])
    for p in good:
        if isinstance(config, PipelineConfig):
            rc = cli.main(rec["task"] + [p])
            if rc != 0:
                fails.append(f"cli.main failed on {p}")
                continue
            exp = open(p + ".out", "rb").read()
            got = open(p + ".srv", "rb").read()
            if not is_float:
                if got != exp:
                    fails.append(f"exact combo bytes differ: {p}")
            elif exp[:2] == b"P4":
                pass  # +-1 may flip dither bits; CLI-campaign rule
            else:
                err = _compare_pm1(got, exp)
                if err:
                    fails.append(f"float combo {err}: {p}")
        else:
            names = config if isinstance(config, tuple) else (config,)
            for n in names:
                serving.process_files([p], str(n), suffix=".one_" + n)
                exp = open(p + ".one_" + n, "rb").read()
                got_path = (p + "." + n + ".srv"
                            if isinstance(config, tuple) else p + ".srv")
                got = open(got_path, "rb").read()
                if n == "thumbnail":
                    # The only float preset (f32 resize matmul): batched
                    # vs single-image dispatch carries the +-1 budget.
                    err = _compare_pm1(got, exp)
                    if err:
                        fails.append(f"preset thumbnail {err}: {p}")
                elif got != exp:
                    fails.append(f"preset {n} bytes differ: {p}")

    # --- resume: delete a random subset of outputs, re-run via the CLI.
    if good and not isinstance(config, PipelineConfig):
        pass  # resume is exercised on the reference-config rounds below
    if good and isinstance(config, PipelineConfig):
        k = int(rng.integers(1, len(good) + 1))
        redo = [good[int(j)] for j in
                rng.choice(len(good), size=k, replace=False)]
        for p in redo:
            os.remove(p + ".srv")
        rc = serve.main(["--resume", "--skip-bad", "--suffix", ".srv",
                         *rec["task"], *paths])
        if rc != 0:
            fails.append("serve --resume rc != 0")
        for p in good:
            if not os.path.exists(p + ".srv"):
                fails.append(f"resume did not restore {p}")
        rec["n_resumed"] = k

    return rec, fails


def run_spatial_round(seed: int, workdir: str) -> tuple[dict, list[str]]:
    """Randomized differential fuzz of the SPATIAL surface:
    `process_file_spatial` / `serve --spatial` — giant-ish
    shapes incl. H not divisible by the mesh (divisor-submesh fallback),
    spatial presets incl. the P4 one, reference configs with resample
    stages (halo resize + band-exchange/all-gather rotation), the "fused"
    pipeline — every output checked against the single-device path."""
    import jax as _jax

    rng = np.random.default_rng(seed)
    fails: list[str] = []
    rec: dict = {"seed": seed, "kind": "spatial"}
    n_dev = len(_jax.devices())

    # Giant-ish shapes relative to the mesh; H divisible by the full mesh
    # about half the time, else odd/partial -> submesh or 1-device path.
    n_files = int(rng.integers(2, 4))
    shapes = []
    for _ in range(n_files):
        if rng.random() < 0.5 and n_dev > 1:
            h = int(rng.integers(3, 30)) * n_dev
        else:
            h = int(rng.integers(17, 220))
        w = int(rng.integers(16, 200))
        shapes.append((h, w))
    paths, imgs = [], []
    for i, (h, w) in enumerate(shapes):
        p = os.path.join(workdir, f"sp{seed}_f{i}.ppm")
        img = np.random.default_rng(seed ^ (104729 * i + 7)).integers(
            0, 256, (h, w, 3), dtype=np.uint8)
        ppm.write_ppm(p, img)
        paths.append(p)
        imgs.append(img)
    rec["shapes"] = [list(s) for s in shapes]

    task_kind = int(rng.integers(0, 3))
    if task_kind == 0:
        # Reference config biased toward resample stages.
        args = []
        w0 = shapes[0][1]
        if rng.random() < 0.75:
            nw = int(rng.integers(max(w0 // 2, 8), 2 * w0))
            # B7 domain (truncated new_height == 0 for ANY file in the
            # set) is the CLI campaign's job; keep this set feasible.
            if all(h * nw // w >= 2 for h, w in shapes):
                args.append(f"-w{nw}")
        if rng.random() < 0.6:
            args.append(f"-r{int(rng.integers(1, 360))}")
        r = rng.random()
        if r < 0.3:
            args.append("-gray")
        elif r < 0.5:
            args.append("-mono")
        if rng.random() < 0.4:
            args.append("-fv" if rng.random() < 0.5 else "-fh")
        if not args:
            args = ["-gray"]
        rec["task"] = args
        rc = serve.main(["--spatial", "--suffix", ".sp", *args, *paths])
        if rc != 0:
            return rec, [f"serve --spatial rc={rc} for {args}"]
        is_float = _has_float_op(args)
        for i, p in enumerate(paths):
            rc = cli.main(args + [p])
            if rc != 0:
                fails.append(f"cli.main failed on {p}")
                continue
            exp = open(p + ".out", "rb").read()
            got = open(p + ".sp", "rb").read()
            if not is_float:
                if got != exp:
                    fails.append(f"spatial exact combo differs: {p} {args}")
            elif exp[:2] == b"P4":
                pass  # +-1 may flip dither bits; CLI-campaign rule
            else:
                err = _compare_pm1(got, exp)
                if err:
                    fails.append(f"spatial float combo {err}: {p} {args}")
    elif task_kind == 1:
        name = PRESET_NAMES[int(rng.integers(0, len(PRESET_NAMES)))]
        rec["task"] = name
        rc = serve.main(["--spatial", "--suffix", ".sp", "--preset", name,
                         *paths])
        if rc != 0:
            return rec, [f"serve --spatial --preset {name} rc={rc}"]
        for p in paths:
            serving.process_files([p], name, suffix=".one")
            exp = open(p + ".one", "rb").read()
            got = open(p + ".sp", "rb").read()
            if name == "thumbnail":
                if exp[:2] != got[:2]:
                    fails.append(f"spatial thumbnail magic differs: {p}")
                else:
                    err = _compare_pm1(got, exp)
                    if err:
                        fails.append(f"spatial thumbnail {err}: {p}")
            elif got != exp:
                fails.append(f"spatial preset {name} differs: {p}")
    else:
        rec["task"] = "fused"
        from imageprocessingtools_tpu.kernels.fused import (
            fused_gray_gauss_histeq,
        )

        for i, p in enumerate(paths):
            out_p = serving.process_file_spatial(p, "fused", suffix=".sp")
            got, _, ft = ppm.read_pnm(out_p)
            exp = np.asarray(fused_gray_gauss_histeq(imgs[i]))
            if ft != ppm.FILETYPE_PGM or got.shape != exp.shape:
                fails.append(f"fused spatial shape/type differs: {p}")
            elif not (got == exp).all():
                fails.append(f"fused spatial pixels differ: {p}")

    # skip-bad through the spatial path: one corrupt file must be skipped
    # and reported without sinking the run.
    if rng.random() < 0.4:
        bad_p = os.path.join(workdir, f"sp{seed}_bad.ppm")
        with open(bad_p, "wb") as f:
            f.write(b"P5 1 1 255 x")
        rc = serve.main(["--spatial", "--skip-bad", "--suffix", ".sb",
                         "-gray", bad_p, paths[0]])
        if rc != 0:
            fails.append("spatial --skip-bad rc != 0")
        if os.path.exists(bad_p + ".sb"):
            fails.append("spatial --skip-bad produced output for bad file")
        if not os.path.exists(paths[0] + ".sb"):
            fails.append("spatial --skip-bad dropped the good neighbour")
        rec["skip_bad_probe"] = True

    return rec, fails


def main() -> None:
    argv = [a for a in sys.argv[1:] if a != "--spatial"]
    spatial_only = "--spatial" in sys.argv[1:]
    n_rounds = int(argv[0]) if len(argv) > 0 else 40
    seed_base = int(argv[1]) if len(argv) > 1 else 300_000
    t0 = time.time()
    rounds, failures = [], []
    with tempfile.TemporaryDirectory() as workdir:
        for i in range(n_rounds):
            # --spatial: every round spatial; default: every 4th round.
            if spatial_only or i % 4 == 3:
                rec, fails = run_spatial_round(seed_base + i, workdir)
                rec["n_files"] = len(rec.get("shapes", []))
                rec["n_bad"] = 0
            else:
                rec, fails = run_round(seed_base + i, workdir)
            if fails:
                rec["FAIL"] = fails
                failures.append(rec)
            rounds.append(rec)
    tally: dict[str, int] = {}
    for r in rounds:
        tally[r["kind"]] = tally.get(r["kind"], 0) + 1
    doc = {
        "date": time.strftime("%Y-%m-%d"),
        "command": (f"python tools/serving_fuzz.py {n_rounds} {seed_base}"
                    + (" --spatial" if spatial_only else "")),
        "n_rounds": n_rounds,
        "seed_base": seed_base,
        "task_mix": tally,
        "mesh_rounds": sum(1 for r in rounds if r.get("mesh")),
        "total_files": sum(r["n_files"] for r in rounds),
        "total_corrupt": sum(r["n_bad"] for r in rounds),
        "contract": (
            "serving == single-image path per file: byte-identical for "
            "exact reference combos and all presets (incl. every member of "
            "a fan-out tuple); header-identical + payload +-1 for float "
            "combos (P4 float skipped); corrupt files recorded in "
            "`failures` with no output and no neighbour effects; "
            "--resume restores exactly the deleted outputs"
        ),
        "failures": failures,
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(doc, indent=2))
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
