"""Batch-processing CLIs: raw FIDs + prior knowledge -> fitted maps
(PyTorch port of :mod:`xmris_tpu.runtime.cli`).

The production entry points for headless deployments.  One command loads a
saved acquisition, runs the batched fit on the card, and writes the result
Dataset:

    xmris-tpu-torch-fit data.npz prior.csv -o fit.npz
    xmris-tpu-torch-fit rawdatajob0.nc prior.csv --mhz 120.0 --sw 10000 -o fit.npz
    xmris-tpu-torch-recon kspace.npz -o image.npz --combine sense
    xmris-tpu-torch-serve incoming/ prior.csv -o results/ --pipeline

Inputs: ``.npz`` archives written by :func:`xmris_tpu_torch.interop.io.save_npz`
(or the JAX package's ``save_npz``: the format is the same), or classic
netCDF-3 files (the Bruker raw exports).  Arrays carrying split real/imag
planes on a ``component`` dimension are recombined automatically.  Output:
an ``.npz`` Dataset archive (``load_dataset_npz`` round-trips it).  A JSON
summary goes to stdout, one line per input.

Each command runs on ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions on the host), which it resolves before any work:
without a card, ``--device cuda`` is a usage error (exit code 2).
``--mesh`` shards the fit's voxel axis over several devices of that kind.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _load_input(path: Path, variable: str | None):
    from xmris_tpu_torch.interop.io import load_dataarray, load_npz

    if path.suffix == ".npz":
        da = load_npz(path)
    else:
        da = load_dataarray(path, variable=variable)
    if "component" in da.dims:
        from xmris_tpu_torch.ops.utils import to_complex

        da = to_complex(da)
    return da


def _parse_mesh(value):
    """argparse type= for --mesh: a device count or 'auto'."""
    if value is None:
        return None
    if value == "auto":
        return "auto"
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected a device count or 'auto', got {value!r}"
        ) from None


def _add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="where the work runs: 'cuda' (the default, the "
                             "card), 'cuda:N', or 'cpu'")


def _resolve_device(parser: argparse.ArgumentParser, value: str):
    """``--device`` as a ``torch.device``; a malformed value, or a CUDA
    device where there is no card, is a usage error (exit code 2)."""
    from xmris_tpu_torch.core.utils import card_device

    try:
        return card_device(value, parser.prog)
    except (RuntimeError, ValueError) as exc:
        parser.error(f"--device {value}: {exc}")


def fit_main(argv: list[str] | None = None) -> int:
    """Entry point of the ``xmris-tpu-torch-fit`` console script."""
    parser = argparse.ArgumentParser(
        prog="xmris-tpu-torch-fit",
        description=(
            "Batch AMARES fitting: load an N-D FID array, fit every voxel "
            "with the batched LM solver on the card, write the result "
            "Dataset."
        ),
    )
    parser.add_argument("input", help=".npz (save_npz) or classic netCDF-3")
    parser.add_argument("prior", help="AMARES prior-knowledge CSV")
    parser.add_argument("-o", "--output", required=True,
                        help="output .npz Dataset archive")
    parser.add_argument("--variable", default=None,
                        help="netCDF variable name (auto-detected if unique)")
    parser.add_argument("--dim", default="time", help="time dimension name")
    parser.add_argument("--mhz", type=float, default=None,
                        help="Larmor frequency [MHz] (else from attrs)")
    parser.add_argument("--sw", type=float, default=None,
                        help="spectral width [Hz] (else from coords/attrs)")
    parser.add_argument("--engine", default="auto",
                        choices=("auto", "xla", "pallas"))
    parser.add_argument("--max-iter", type=int, default=60)
    parser.add_argument("--kernel-version", type=int, default=9)
    parser.add_argument("--chunk-size", type=int, default=None)
    parser.add_argument("--mesh", default=None, type=_parse_mesh,
                        help="shard the fit over devices: a device count, "
                             "'auto' (all visible devices), or omit for "
                             "single-device")
    parser.add_argument("--no-init-lm", action="store_true",
                        help="skip the template-fit initialization pass")
    parser.add_argument("--verbose", action="store_true")
    _add_device(parser)
    args = parser.parse_args(argv)
    device = _resolve_device(parser, args.device)

    import numpy as np

    from xmris_tpu_torch.fitting.amares import fit_amares
    from xmris_tpu_torch.interop.io import save_dataset_npz

    t0 = time.perf_counter()
    da = _load_input(Path(args.input), args.variable)
    t_load = time.perf_counter() - t0

    t0 = time.perf_counter()
    ds = fit_amares(
        da,
        args.prior,
        dim=args.dim,
        mhz=args.mhz,
        sw=args.sw,
        engine=args.engine,
        max_iter=args.max_iter,
        kernel_version=args.kernel_version,
        chunk_size=args.chunk_size,
        initialize_with_lm=not args.no_init_lm,
        verbose=args.verbose,
        mesh=args.mesh,
        device=device,
    )
    t_fit = time.perf_counter() - t0

    out = Path(args.output)
    save_dataset_npz(ds, out)

    conv = np.asarray(ds["fit_converged"].values)
    n_voxels = int(conv.size)
    summary = {
        "input": str(args.input),
        "output": str(out),
        "voxels": n_voxels,
        "metabolites": [
            str(m) for m in ds["amplitude"].coords["Metabolite"].values
        ],
        "converged_frac": round(float(conv.mean()), 4),
        "load_s": round(t_load, 3),
        "fit_s": round(t_fit, 3),
        "voxels_per_s": round(n_voxels / max(t_fit, 1e-9), 1),
    }
    print(json.dumps(summary))
    return 0 if conv.all() else 2


def recon_main(argv: list[str] | None = None) -> int:
    """Entry point of the ``xmris-tpu-torch-recon`` console script.

    Cartesian k-space -> image: centered iFFT over the k-space dimensions
    plus a coil combine (RSS, or matched-filter SENSE with self-calibrated
    maps), on ``--device``; the image is written from the host.
    """
    parser = argparse.ArgumentParser(
        prog="xmris-tpu-torch-recon",
        description=(
            "Cartesian k-space reconstruction: centered iFFT + coil "
            "combine, written back as an .npz image archive."
        ),
    )
    parser.add_argument("input", help=".npz (save_npz) or classic netCDF-3")
    parser.add_argument("-o", "--output", required=True,
                        help="output .npz image archive")
    parser.add_argument("--variable", default=None,
                        help="netCDF variable name (auto-detected if unique)")
    parser.add_argument("--dims", default=None,
                        help="comma-separated k-space dims (default: all "
                             "kx/ky/kz present)")
    parser.add_argument("--coil-dim", default=None,
                        help="coil dimension (default: the vocabulary term)")
    parser.add_argument("--combine", default="rss",
                        choices=("rss", "sense", "none"),
                        help="coil combine: RSS magnitude, matched-filter "
                             "SENSE (phase-preserving), or none")
    parser.add_argument("--calib-frac", type=float, default=0.25,
                        help="SENSE calibration-region fraction")
    _add_device(parser)
    args = parser.parse_args(argv)
    device = _resolve_device(parser, args.device)

    from xmris_tpu_torch.core.config import DIMS
    from xmris_tpu_torch.interop.io import save_npz

    t0 = time.perf_counter()
    da = _load_input(Path(args.input), args.variable).to(device)
    dims = args.dims.split(",") if args.dims else None
    coil_dim = args.coil_dim or DIMS.coil

    if args.combine == "sense":
        from xmris_tpu_torch.recon.sense import sense_reconstruct

        img = sense_reconstruct(da, dims=dims, coil_dim=coil_dim,
                                calib_frac=args.calib_frac, device=device)
    elif args.combine == "rss":
        from xmris_tpu_torch.recon.kspace import rss_reconstruct

        img = rss_reconstruct(da, dims=dims, coil_dim=coil_dim)
    else:
        from xmris_tpu_torch.recon.kspace import kspace_to_image

        img = kspace_to_image(da, dims=dims)
    img = img.to("cpu")
    elapsed = time.perf_counter() - t0

    out = Path(args.output)
    save_npz(img, out)
    print(json.dumps({
        "input": str(args.input),
        "output": str(out),
        "shape": list(img.values.shape),
        "dims": [str(d) for d in img.dims],
        "combine": args.combine,
        "recon_s": round(elapsed, 3),
    }))
    return 0


def serve_main(argv: list[str] | None = None) -> int:
    """Entry point of the ``xmris-tpu-torch-serve`` console script.

    Streaming batch server: watch a directory for FID archives, fit each
    on the card, write result Datasets to an output directory, and emit
    one JSON status line per grid.  The first grid builds the kernels;
    every later grid reuses the loaded libraries.

    Producers should write atomically (write to ``*.tmp``/``*.part``,
    then rename into the watched pattern); in-flight suffixes are
    ignored.  Each file is processed once per server lifetime, oldest
    first; with ``--state-file`` the processed-name ledger persists, so a
    restarted server resumes where it stopped (only SUCCESSFULLY handled
    grids are recorded, after their result is written: at-least-once
    semantics, so both a crash mid-fit and a transient per-grid failure
    are retried by the next server process).  ``--once`` drains what is
    pending and exits (returns 2 if any grid failed or left unconverged
    voxels); without it the server polls forever and exits cleanly on
    Ctrl-C.  The prior and ``--device`` are resolved once, before the
    server idles: a bad prior or a missing card fails at start-up.

    Results are lean by default: parameter/CRLB/SNR maps plus the
    convergence mask, without the per-voxel time-domain curves; pass
    ``--curves`` for the full ``fit_amares`` dataset
    (``raw_data``/``fit_data``/``residuals``).

    ``--pipeline`` overlaps the three per-grid stages: a loader thread
    reads grid N+1 and starts its upload
    (:func:`~xmris_tpu_torch.fitting.amares.stage_device_fids`, an
    asynchronous copy from pinned memory on the card), and a writer thread
    saves grid N-1, while the main thread fits grid N.  At most ONE grid's
    planes are staged ahead of the grid that is fitting (a token the fit
    stage releases when it takes the staged grid), so device memory holds
    at most two grids of planes whatever the queue depth.  A staging
    failure falls back to the in-fit upload and emits a one-line JSON
    warning on stderr.  Record order, ledger semantics and exit codes are
    the serial mode's; ``wall_s`` in each record spans ingest-start to
    result-written, so overlapped grids can report a larger wall than
    their fit.
    """
    parser = argparse.ArgumentParser(
        prog="xmris-tpu-torch-serve",
        description=(
            "Streaming AMARES fitting: watch a directory for FID "
            "archives, fit each arriving grid on the card, write result "
            "Datasets, print one JSON status line per grid."
        ),
    )
    parser.add_argument("watch_dir", help="directory to watch for inputs")
    parser.add_argument("prior", help="AMARES prior-knowledge CSV")
    parser.add_argument("-o", "--output-dir", required=True,
                        help="directory for *_fit.npz result archives")
    parser.add_argument("--pattern", default="*.npz",
                        help="glob of input files inside watch_dir")
    parser.add_argument("--poll", type=float, default=0.5,
                        help="poll interval [s] while idle")
    parser.add_argument("--once", action="store_true",
                        help="drain pending files, then exit")
    parser.add_argument("--max-files", type=int, default=None,
                        help="exit after this many grids")
    parser.add_argument("--state-file", default=None,
                        help="persist processed-file names here (one per "
                             "line, appended after each grid) so a "
                             "restarted server resumes where it stopped")
    parser.add_argument("--variable", default=None,
                        help="netCDF variable name (auto-detected if unique)")
    parser.add_argument("--dim", default="time", help="time dimension name")
    parser.add_argument("--mhz", type=float, default=None,
                        help="Larmor frequency [MHz] (else from attrs)")
    parser.add_argument("--sw", type=float, default=None,
                        help="spectral width [Hz] (else from coords/attrs)")
    parser.add_argument("--engine", default="auto",
                        choices=("auto", "xla", "pallas"))
    parser.add_argument("--max-iter", type=int, default=60)
    parser.add_argument("--kernel-version", type=int, default=9)
    parser.add_argument("--mesh", default=None, type=_parse_mesh,
                        help="shard the fit over devices: a device count, "
                             "'auto' (all visible devices), or omit for "
                             "single-device")
    parser.add_argument("--pipeline", action="store_true",
                        help="overlap load/fit/write across grids with "
                             "loader+writer threads")
    parser.add_argument("--curves", action="store_true",
                        help="include raw_data/fit_data/residuals curves "
                             "in results (3 full-grid complex arrays; "
                             "off by default for serving throughput)")
    _add_device(parser)
    args = parser.parse_args(argv)
    device = _resolve_device(parser, args.device)

    import numpy as np

    from xmris_tpu_torch.fitting.amares import fit_amares, stage_device_fids
    from xmris_tpu_torch.fitting.prior import load_prior_knowledge
    from xmris_tpu_torch.interop.io import save_dataset_npz

    watch = Path(args.watch_dir)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # Parse the prior once: every grid shares it, and a parse error
    # surfaces before the server starts idling.
    prior = load_prior_knowledge(args.prior)

    seen: set[str] = set()
    # Resume support: names already handled by a previous server process.
    # A name is appended only AFTER its grid was successfully handled, so
    # both a crash mid-fit and a transient failure re-process that grid
    # on restart (at-least-once semantics).
    state_path = Path(args.state_file) if args.state_file else None
    if state_path is not None and state_path.exists():
        seen.update(
            ln.strip()
            for ln in state_path.read_text().splitlines()
            if ln.strip()
        )
    n_done = 0
    any_bad = False

    def _mtime_or_zero(p: Path) -> float:
        # A file may vanish between glob and stat (operator cleanup);
        # losing its ordering hint is harmless: processing it then reports
        # a load error, or the next poll simply no longer sees it.
        try:
            return p.stat().st_mtime
        except OSError:
            return 0.0

    # --- Per-grid pipeline stages -----------------------------------------
    # Each batch runs through load -> fit -> write.  With --pipeline the
    # load of grid N+1 and the save/ledger of grid N-1 run on side threads
    # while the card fits grid N.  The single writer thread keeps the JSON
    # record order, the ledger appends and the exit-code bookkeeping
    # exactly serial: records complete in scheduling order because every
    # stage is FIFO.

    def _load_stage(p: Path):
        """(da, None) or (None, error): host load only, never raises."""
        try:
            return _load_input(p, args.variable), None
        except Exception as e:  # noqa: BLE001 - keep serving
            return None, e

    def _fit_stage(da, dev=None):
        """(ds, None) or (None, error): never raises."""
        try:
            return fit_amares(
                da, prior, dim=args.dim, mhz=args.mhz, sw=args.sw,
                engine=args.engine, max_iter=args.max_iter,
                kernel_version=args.kernel_version,
                return_curves=args.curves,
                device_fids=dev,
                mesh=args.mesh,
                device=device,
            ), None
        except Exception as e:  # noqa: BLE001 - keep serving
            return None, e

    def _write_stage(p: Path, ds, err, t0) -> tuple[dict, bool]:
        """Save + status record + ledger append.

        Returns ``(record, clean)`` where ``clean`` is False on any error
        or any unconverged voxel (drives the exit code; kept separate from
        the record's rounded ``converged_frac``)."""
        record: dict = {"file": p.name}
        clean = False
        try:
            if err is not None:
                raise err
            out = out_dir / (p.stem + "_fit.npz")
            save_dataset_npz(ds, out)
            conv = np.asarray(ds["fit_converged"].values)
            record.update(
                status="ok",
                output=out.name,
                voxels=int(conv.size),
                converged_frac=round(float(conv.mean()), 4),
                wall_s=round(time.perf_counter() - t0, 3),
            )
            clean = bool(conv.all())
        except Exception as e:  # noqa: BLE001 - keep serving
            record.update(status="error", error=repr(e)[:300])
        # One write call, not print(): the writer thread emits records
        # while the main thread prints fit progress, and print()'s
        # separate payload/newline writes let the other thread splice into
        # the middle of a record line.
        sys.stdout.write(json.dumps(record) + "\n")
        sys.stdout.flush()
        # Only SUCCESSFUL grids enter the persistent ledger: a transient
        # failure must be retried by a restarted server, not permanently
        # skipped.  Within one server lifetime the in-memory `seen` still
        # prevents hot-looping on a permanently bad file.
        if state_path is not None and record["status"] == "ok":
            with open(state_path, "a") as sf:
                sf.write(p.name + "\n")
        return record, clean

    def _drain_batch(pending) -> None:
        """Run one batch through the three stages (threaded or serial)."""
        nonlocal n_done, any_bad
        if not args.pipeline:
            for p in pending:
                t0 = time.perf_counter()
                da, err = _load_stage(p)
                ds = None
                if err is None:
                    ds, err = _fit_stage(da, None)
                _, clean = _write_stage(p, ds, err, t0)
                if not clean:
                    any_bad = True
                n_done += 1
            return

        import queue
        import threading

        load_q: queue.Queue = queue.Queue(maxsize=2)
        write_q: queue.Queue = queue.Queue(maxsize=2)
        results: list[bool] = []
        # At most ONE grid's device planes may be staged ahead of the grid
        # currently fitting (the token is released when the main stage
        # dequeues the staged grid).  Host-side prefetch of the loaded
        # arrays keeps the full queue depth: that is host RAM.
        stage_sem = threading.Semaphore(1)

        def loader():
            for p in pending:
                t0 = time.perf_counter()
                da, err = _load_stage(p)
                dev = None
                staged = False
                if err is None:
                    stage_sem.acquire()
                    staged = True
                    try:
                        # Start the grid's upload so that it overlaps the
                        # previous grid's fit.
                        dev = stage_device_fids(da, dim=args.dim,
                                                device=device)
                    except Exception as e:  # noqa: BLE001 - fit retries
                        stage_sem.release()
                        staged = False
                        dev = None
                        # A persistently failing prefetch silently turns
                        # every grid into the in-fit upload: make the
                        # degradation visible (stderr keeps the stdout
                        # record stream one line per grid).
                        print(
                            json.dumps({
                                "file": p.name, "status": "warn",
                                "warning": "device prefetch failed; "
                                           "falling back to in-fit upload",
                                "error": repr(e)[:200],
                            }),
                            file=sys.stderr, flush=True,
                        )
                load_q.put((p, t0, da, dev, err, staged))
            load_q.put(None)

        def writer():
            while True:
                item = write_q.get()
                if item is None:
                    return
                try:
                    _, clean = _write_stage(*item)
                except Exception as e:  # noqa: BLE001 - a dead writer
                    # deadlocks the pipeline: the bounded write_q fills and
                    # the main thread blocks forever on put() and the
                    # timeoutless join().  Keep draining, record the grid
                    # as failed, and surface the cause on stderr (serial
                    # mode would have crashed visibly instead).
                    clean = False
                    try:
                        print(
                            json.dumps({
                                "file": str(item[0].name),
                                "status": "error",
                                "error": "write stage failed: "
                                         + repr(e)[:200],
                            }),
                            file=sys.stderr, flush=True,
                        )
                    except Exception:  # pragma: no cover - stderr gone too
                        pass
                results.append(clean)

        lt = threading.Thread(target=loader, daemon=True)
        wt = threading.Thread(target=writer, daemon=True)
        lt.start()
        wt.start()
        try:
            while True:
                item = load_q.get()
                if item is None:
                    break
                p, t0, da, dev, err, staged = item
                if staged:
                    # This grid's planes are now the IN-USE set, not a
                    # prefetch: let the loader stage the next grid.
                    stage_sem.release()
                ds = None
                if err is None:
                    ds, err = _fit_stage(da, dev)
                write_q.put((p, ds, err, t0))
        finally:
            write_q.put(None)
            wt.join()
            # The loader (daemon) can still be blocked on a full load_q if
            # the main stage aborted mid-batch; don't hang shutdown on it.
            lt.join(timeout=5.0)
        for clean in results:
            if not clean:
                any_bad = True
            n_done += 1

    try:
        while True:
            pending = sorted(
                (p for p in watch.glob(args.pattern)
                 if p.name not in seen
                 and not p.name.endswith((".tmp", ".part"))
                 # never re-ingest our own results when the output
                 # directory overlaps the watch glob
                 and not p.name.endswith("_fit.npz")),
                key=lambda p: (_mtime_or_zero(p), p.name),
            )
            if not pending:
                if args.once:
                    break
                time.sleep(args.poll)
                continue
            if args.max_files is not None:
                pending = pending[: max(0, args.max_files - n_done)]
            seen.update(p.name for p in pending)
            _drain_batch(pending)
            if args.max_files is not None and n_done >= args.max_files:
                return 2 if any_bad else 0
    except KeyboardInterrupt:  # pragma: no cover - interactive exit
        pass
    return 2 if any_bad else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(fit_main())
