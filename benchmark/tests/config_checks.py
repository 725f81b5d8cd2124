"""The check of one configuration file against its own source, for every
configuration a manifest lists and for the test data beside this module.

A configuration (``configs/<name>.json``) is an MRSI deployment: its
acquisition, the phantom the traffic plants, and the prior the fit uses.
:func:`check_config` holds it to what the harness and the reference need,
whatever the protocol:

* the acquisition's keys are there and positive;
* the phantom's lines are the prior's metabolites, in order, each inside
  its shift and linewidth bounds;
* the program's prior parser and the reference's read the same prior: K
  lines, four free parameters a line with g fixed at 0, and the same
  initial values and bounds (the reference refuses any other prior);
* ``reduced`` names only the deployment's scale (:data:`SCALE`), never a
  width (points, zero-fill, the prior, the phantom's lines), each key one
  the file has and explains under ``assumed``; a cut grid keeps at least
  :data:`MIN_VOXELS`.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ACQUISITION = ("n_time", "zero_fill", "sw_hz", "mhz", "lb_hz", "noise_sigma")
FIXTURE = HERE / "data" / "p31_brain7t.json"
# What a cut may change: the grid's voxels, and the coils of an array where
# the card forces it.
SCALE = ("grid", "n_coils")
# A quarter of the bench grid's 32 x 32 x 16 voxels: a cut deployment, not
# a toy.
MIN_VOXELS = 32 * 32 * 16 // 4


def fixture(grid=None) -> dict:
    """The 12-line 7 T brain configuration of the test data, at ``grid``
    where given."""
    conf = json.loads(FIXTURE.read_text())
    if grid is not None:
        conf["grid"] = list(grid)
    return conf


def manifest_configs(man: dict, root: Path):
    """``(entry, file's content)`` of every configuration ``man`` lists,
    its files found under ``root``."""
    return [(c, json.loads((root / c["file"]).read_text())) for c in man["configs"]]


def check_config(entry: dict, conf: dict) -> None:
    """Assert that ``conf``, the file of the manifest's ``entry``, holds
    what the module's docstring lists."""
    import torch

    from benchmark.reference import fit as rfit
    from xmris_tpu_torch.fitting.prior import prior_from_csv_text

    name = entry["name"]
    assert conf["name"] == name, (name, conf["name"])
    assert conf["source"] == entry["source"], name
    assert conf["reduced"] == entry["reduced"], name

    grid = conf["grid"]
    assert len(grid) == 3 and all(isinstance(n, int) and n > 0 for n in grid), grid
    for key in ACQUISITION:
        assert conf[key] > 0, (name, key)
    assert conf["zero_fill"] >= conf["n_time"], name
    if "n_coils" in conf:
        assert conf["n_coils"] > 0 and conf["coil_maps"]["width"] > 0, name

    pk = prior_from_csv_text(conf["prior_csv"], name)
    init, lower, upper = rfit.parse_prior(conf["prior_csv"])
    k = pk.n_peaks
    assert [p["name"] for p in conf["peaks"]] == pk.metabolites, name
    assert init.shape == (k, 4) and pk.n_free == 4 * k, (name, k, pk.n_free)
    slots = np.asarray(pk.pmap.idx).reshape(k, 5)
    assert np.array_equal(slots[:, :4], np.arange(4 * k).reshape(k, 4)), name
    assert (slots[:, 4] == -1).all(), name
    assert (np.asarray(pk.pmap.offset).reshape(k, 5)[:, 4] == 0).all(), name
    assert (np.asarray(pk.pmap.scale).reshape(k, 5)[:, :4] == 1).all(), name
    for ours, theirs, what in ((pk.init_free, init, "initial values"),
                               (pk.lower, lower, "lower bounds"),
                               (pk.upper, upper, "upper bounds")):
        assert torch.equal(torch.as_tensor(ours).reshape(k, 4), theirs), (name, what)

    for p, lo, hi in zip(conf["peaks"], lower.tolist(), upper.tolist()):
        assert lo[1] < p["shift_ppm"] < hi[1], (name, p["name"], "shift")
        assert lo[2] < p["linewidth_hz"] < hi[2], (name, p["name"], "linewidth")
        assert p["amplitude"] is None or p["amplitude"] > 0, (name, p["name"])
    if any(p["amplitude"] is None for p in conf["peaks"]):
        lo, hi = conf["pcr_amplitude_range"]
        assert 0 < lo <= hi, name

    assert isinstance(conf["reduced"], list), name
    for key in conf["reduced"]:
        assert key in SCALE and key in conf, (name, key, "not a cut of scale")
        assert conf.get("assumed", {}).get(key), (name, key, "no assumed entry")
    assert int(np.prod(grid)) >= MIN_VOXELS, (name, grid, "under the floor")
