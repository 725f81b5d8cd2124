"""The port's console scripts (``xmris_tpu_torch.runtime.cli``) against the
JAX package's, and the serve semantics of ``tests/test_cli.py:118-389``.

Both packages read the same ``.npz`` inputs (the format is shared) and run
on the CPU: the port with ``--device cpu``, where ``--engine auto`` is the
tensor LM, as the reference's ``auto`` is its XLA LM off the TPU.  The
records, ledgers and exit codes must be the reference's (``wall_s``
aside) and the result maps within the tolerances of
``test_torch_fit_amares.py`` (parameters rtol/atol 2e-3, CRLB % 2e-2).
"""

import builtins
import json
import threading

import numpy as np
import pytest
import torch

from xmris_tpu.interop.io import save_npz as ref_save_npz
from xmris_tpu.ops.utils import to_real_imag as ref_to_real_imag
from xmris_tpu.runtime import cli as ref_cli

from xmris_tpu_torch.interop.io import load_dataset_npz, load_npz, save_npz
from xmris_tpu_torch.runtime import cli

from test_fitting import PK_CSV, make_phantom
from test_recon import make_kspace

FIXED_G_CSV = PK_CSV.replace('"(0, 1)","(0, 1)"', "fixed,fixed")
PARAMS = ("amplitude", "chem_shift", "linewidth", "phase")


@pytest.fixture
def pk(tmp_path):
    path = tmp_path / "pk.csv"
    path.write_text(FIXED_G_CSV)
    return path


def _records(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def _serve(watch, pk, out_dir, *extra):
    return cli.serve_main([str(watch), str(pk), "-o", str(out_dir), "--once",
                           "--max-iter", "40", "--device", "cpu", *extra])


def _assert_maps_close(path, ref_path):
    got, ref = load_dataset_npz(path), load_dataset_npz(ref_path)
    for name in PARAMS:
        np.testing.assert_allclose(got[name].values, ref[name].values,
                                   rtol=2e-3, atol=2e-3, err_msg=name)
    np.testing.assert_allclose(got["crlb"].values, ref["crlb"].values,
                               rtol=2e-2, atol=1e-4)
    np.testing.assert_array_equal(got["fit_converged"].values,
                                  ref["fit_converged"].values)
    assert got["amplitude"].dims == ref["amplitude"].dims


# ---------------------------------------------------------------------------
# Against the JAX package's scripts
# ---------------------------------------------------------------------------


def test_fit_main_matches_reference(tmp_path, pk, capsys):
    """``--mesh 2`` in both packages on the same archive: the summary's
    voxels, metabolites and converged share, the exit code, and the maps.
    The prior fixes g, as ``test_torch_fit_amares.py``'s does: with g free
    the two LMs stop at different points on one of the three voxels (the
    port at the lower residual, 124.62 against 125.98)."""
    inp = tmp_path / "fids.npz"
    ref_save_npz(make_phantom(n_voxels=3, n_points=256), inp)
    argv = [str(inp), str(pk), "--max-iter", "40", "--mesh", "2"]
    rc_ref = ref_cli.fit_main(argv + ["-o", str(tmp_path / "ref.npz")])
    ref = _records(capsys)[-1]
    rc = cli.fit_main(argv + ["-o", str(tmp_path / "got.npz"), "--device", "cpu"])
    got = _records(capsys)[-1]
    assert rc == rc_ref == 0
    for key in ("voxels", "metabolites", "converged_frac"):
        assert got[key] == ref[key], key
    _assert_maps_close(tmp_path / "got.npz", tmp_path / "ref.npz")
    ds = load_dataset_npz(tmp_path / "got.npz")
    assert {"raw_data", "fit_data", "residuals"} <= set(ds)


def test_serve_main_matches_reference(tmp_path, pk, capsys):
    """``serve --once --mesh 2`` of both packages on one directory (two
    grids, a corrupt archive, an in-flight file and a stray text file):
    the same records but ``wall_s``, the same ledger and exit code, and
    each grid's maps within tolerance."""
    watch = tmp_path / "in"
    watch.mkdir()
    for i in range(2):
        ref_save_npz(make_phantom(n_voxels=3, n_points=256), watch / f"g{i}.npz")
    (watch / "bad.npz").write_bytes(b"not an archive")
    (watch / "g9.npz.part").write_bytes(b"junk")
    (watch / "notes.txt").write_text("not a grid")
    runs = {}
    for tag, main, extra in (("ref", ref_cli.serve_main, []),
                             ("port", cli.serve_main, ["--device", "cpu"])):
        state = tmp_path / f"{tag}.state"
        rc = main([str(watch), str(pk), "-o", str(tmp_path / tag), "--once",
                   "--max-iter", "40", "--mesh", "2", "--state-file",
                   str(state)] + extra)
        records = _records(capsys)
        for r in records:
            r.pop("wall_s", None)
            r.pop("error", None)  # the exception's text is the package's
        runs[tag] = (rc, records, state.read_text().split())
    assert runs["port"] == runs["ref"]
    rc, records, ledger = runs["port"]
    assert rc == 2 and ledger == ["g0.npz", "g1.npz"]
    assert [r["status"] for r in records] == ["ok", "ok", "error"]
    for i in range(2):
        _assert_maps_close(tmp_path / "port" / f"g{i}_fit.npz",
                           tmp_path / "ref" / f"g{i}_fit.npz")


def test_serve_main_free_g_matches_reference_by_cost(tmp_path, capsys):
    """``serve --once --mesh 2`` with the prior's g free, as users' default
    priors run it: the same records but ``wall_s``, ledger and exit code,
    and each voxel's residual cost at most 1.005x the reference's (the
    sum at most 1.002x; the bounds of ``chip_smoke.py``'s free-g phase).
    The maps are not held by tolerance: the two LMs stop at different
    points on one voxel, the port at the lower residual."""
    watch = tmp_path / "in"
    watch.mkdir()
    ref_save_npz(make_phantom(n_voxels=3, n_points=256), watch / "g0.npz")
    pk = tmp_path / "pk.csv"
    pk.write_text(PK_CSV)
    runs = {}
    for tag, main, extra in (("ref", ref_cli.serve_main, []),
                             ("port", cli.serve_main, ["--device", "cpu"])):
        state = tmp_path / f"{tag}.state"
        rc = main([str(watch), str(pk), "-o", str(tmp_path / tag), "--once",
                   "--max-iter", "40", "--mesh", "2", "--curves",
                   "--state-file", str(state)] + extra)
        records = _records(capsys)
        for r in records:
            r.pop("wall_s", None)
        runs[tag] = (rc, records, state.read_text().split())
    assert runs["port"] == runs["ref"]
    assert [r["status"] for r in runs["port"][1]] == ["ok"]
    cost = {tag: (np.abs(load_dataset_npz(tmp_path / tag / "g0_fit.npz")
                         ["residuals"].values) ** 2).sum(-1)
            for tag in runs}
    assert np.all(cost["port"] <= 1.005 * cost["ref"]), cost
    assert cost["port"].sum() <= 1.002 * cost["ref"].sum(), cost


@pytest.mark.parametrize("combine", ["rss", "sense", "none"])
def test_recon_main_matches_reference(tmp_path, capsys, combine):
    da, _, rss_truth = make_kspace(n=32, n_coils=3)
    inp = tmp_path / "ksp.npz"
    ref_save_npz(da, inp)
    argv = [str(inp), "--combine", combine]
    assert ref_cli.recon_main(argv + ["-o", str(tmp_path / "ref.npz")]) == 0
    ref = _records(capsys)[-1]
    assert cli.recon_main(argv + ["-o", str(tmp_path / "got.npz"),
                                  "--device", "cpu"]) == 0
    got = _records(capsys)[-1]
    for key in ("shape", "dims", "combine"):
        assert got[key] == ref[key], key
    img, img_ref = load_npz(tmp_path / "got.npz"), load_npz(tmp_path / "ref.npz")
    assert img.dims == img_ref.dims
    scale = np.max(np.abs(img_ref.values))
    np.testing.assert_allclose(img.values, img_ref.values, rtol=0,
                               atol=1e-6 * scale)
    if combine == "rss":
        np.testing.assert_allclose(np.abs(img.values), rss_truth, atol=1e-5)


def test_fit_main_recombines_component_input(tmp_path, pk, capsys):
    inp = tmp_path / "planar.npz"
    ref_save_npz(ref_to_real_imag(make_phantom(n_voxels=2, n_points=256)), inp)
    rc = cli.fit_main([str(inp), str(pk), "-o", str(tmp_path / "fit.npz"),
                       "--max-iter", "40", "--device", "cpu"])
    assert rc == 0
    assert load_dataset_npz(tmp_path / "fit.npz")["fit_converged"].values.all()


# ---------------------------------------------------------------------------
# Serve semantics (tests/test_cli.py:118-389)
# ---------------------------------------------------------------------------


def test_serve_drains_and_ignores_junk(tmp_path, pk, capsys):
    watch = tmp_path / "in"
    watch.mkdir()
    for i in range(2):
        save_npz(make_phantom(n_voxels=2, n_points=256), watch / f"grid{i}.npz")
    (watch / "grid9.npz.tmp").write_bytes(b"junk")
    (watch / "notes.txt").write_text("not a grid")
    assert _serve(watch, pk, tmp_path / "out") == 0
    records = _records(capsys)
    assert sorted(r["file"] for r in records) == ["grid0.npz", "grid1.npz"]
    for r in records:
        assert r["status"] == "ok" and r["converged_frac"] == 1.0
        assert r["voxels"] == 2 and r["wall_s"] >= 0
        ds = load_dataset_npz(tmp_path / "out" / r["output"])
        assert ds["fit_converged"].values.all() and "raw_data" not in ds


def test_serve_error_keeps_serving(tmp_path, pk, capsys):
    watch = tmp_path / "in"
    watch.mkdir()
    (watch / "bad.npz").write_bytes(b"this is not an npz archive")
    save_npz(make_phantom(n_voxels=2, n_points=256), watch / "good.npz")
    assert _serve(watch, pk, tmp_path / "out") == 2
    by_file = {r["file"]: r for r in _records(capsys)}
    assert by_file["bad.npz"]["status"] == "error"
    assert by_file["good.npz"]["status"] == "ok"
    assert (tmp_path / "out" / "good_fit.npz").exists()


def test_serve_state_file_resumes(tmp_path, pk, capsys):
    watch = tmp_path / "in"
    watch.mkdir()
    state = tmp_path / "serve.state"
    da = make_phantom(n_voxels=2, n_points=256)
    save_npz(da, watch / "first.npz")
    assert _serve(watch, pk, tmp_path / "out", "--state-file", str(state)) == 0
    assert state.read_text().splitlines() == ["first.npz"]
    capsys.readouterr()
    save_npz(da, watch / "second.npz")
    assert _serve(watch, pk, tmp_path / "out", "--state-file", str(state)) == 0
    assert [r["file"] for r in _records(capsys)] == ["second.npz"]
    assert sorted(state.read_text().split()) == ["first.npz", "second.npz"]


def test_serve_pipeline_matches_serial(tmp_path, pk, capsys):
    """The loader/writer threads (with the planes staged one grid ahead)
    give the serial mode's records, outputs, ledger and exit code."""
    watch = tmp_path / "in"
    watch.mkdir()
    da = make_phantom(n_voxels=2, n_points=256)
    for i in range(3):
        save_npz(da, watch / f"g{i}.npz")
    (watch / "bad.npz").write_bytes(b"junk")
    runs = {}
    for tag, extra in (("pipe", ["--pipeline"]), ("serial", [])):
        state = tmp_path / f"{tag}.state"
        rc = _serve(watch, pk, tmp_path / f"out_{tag}", "--state-file",
                    str(state), *extra)
        records = _records(capsys)
        for r in records:
            r.pop("wall_s", None)
        runs[tag] = (rc, records, sorted(state.read_text().split()),
                     sorted(p.name for p in (tmp_path / f"out_{tag}").glob("*_fit.npz")))
    assert runs["pipe"] == runs["serial"]
    rc, records, ledger, outs = runs["pipe"]
    assert rc == 2
    assert sorted(r["file"] for r in records) == ["bad.npz", "g0.npz", "g1.npz", "g2.npz"]
    assert ledger == ["g0.npz", "g1.npz", "g2.npz"]
    assert outs == ["g0_fit.npz", "g1_fit.npz", "g2_fit.npz"]
    for name in outs:
        a = load_dataset_npz(tmp_path / "out_pipe" / name)
        b = load_dataset_npz(tmp_path / "out_serial" / name)
        for var in PARAMS:
            np.testing.assert_array_equal(a[var].values, b[var].values)


def test_serve_pipeline_survives_a_write_stage_crash(tmp_path, pk, capsys,
                                                     monkeypatch):
    """A ledger append that raises must not deadlock ``--pipeline``: the
    writer keeps draining, the grids count as failed (exit code 2) and the
    cause goes to stderr."""
    watch = tmp_path / "in"
    watch.mkdir()
    da = make_phantom(n_voxels=2, n_points=256)
    for i in range(3):
        save_npz(da, watch / f"g{i}.npz")
    ledger = tmp_path / "serve.state"
    ledger.touch()
    real_open = builtins.open

    def failing_append(file, mode="r", *a, **kw):
        if str(file) == str(ledger) and "a" in mode:
            raise OSError("simulated ledger write failure")
        return real_open(file, mode, *a, **kw)

    monkeypatch.setattr(builtins, "open", failing_append)
    box = {}
    th = threading.Thread(target=lambda: box.update(rc=_serve(
        watch, pk, tmp_path / "out", "--pipeline", "--state-file", str(ledger))),
        daemon=True)
    th.start()
    th.join(timeout=300.0)
    assert not th.is_alive(), "pipeline serve deadlocked on a writer crash"
    assert box["rc"] == 2
    assert "write stage failed" in capsys.readouterr().err
    assert len(list((tmp_path / "out").glob("*_fit.npz"))) == 3


def test_serve_pipeline_max_files(tmp_path, pk, capsys):
    watch = tmp_path / "in"
    watch.mkdir()
    da = make_phantom(n_voxels=2, n_points=256)
    for i in range(4):
        save_npz(da, watch / f"g{i}.npz")
    assert _serve(watch, pk, tmp_path / "out", "--pipeline", "--max-files", "2") == 0
    assert len(_records(capsys)) == 2
    assert len(list((tmp_path / "out").glob("*_fit.npz"))) == 2


# ---------------------------------------------------------------------------
# Usage errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("main", ["fit_main", "recon_main", "serve_main"])
def test_device_cuda_without_a_card_is_a_usage_error(tmp_path, pk, capsys,
                                                     monkeypatch, main):
    """Resolved at start-up, before any input is read or output made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {
        "fit_main": ["in.npz", str(pk), "-o", str(tmp_path / "out.npz")],
        "recon_main": ["in.npz", "-o", str(tmp_path / "out.npz")],
        "serve_main": [str(tmp_path), str(pk), "-o", str(tmp_path / "out")],
    }[main]
    with pytest.raises(SystemExit) as exc:
        getattr(cli, main)(argv + ["--device", "cuda"])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_mesh_garbage_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.fit_main(["in.npz", "pk.csv", "-o", "out.npz", "--mesh", "all"])
    assert exc.value.code == 2
    assert "device count or 'auto'" in capsys.readouterr().err
