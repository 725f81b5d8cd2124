"""The one traffic generator: a cell's pool of grids, made from ``--seed``.

A traffic mix is a data file beside this module (``<traffic>.json``) that
names the pool's size and what each request asks of the program; the
configuration names the acquisition.  From both, as the harness loads
them, this module makes the pool on the device.  It is the benchmark's own copy of the bench phantom
(``xmris_tpu_torch/bench_inputs.py``, itself ``bench.py:33-84``) with the
seed as an argument: pool grid ``i`` of seed ``s`` is drawn from
``numpy.random.default_rng(s * seed_stride + i)``, so seed 0's first grid is
``bench_inputs.make_inputs()`` bit for bit.  The draws are numpy's (that
identity needs them); the arithmetic runs on the device in float64, in
``make_inputs``' order, and rounds to float32 once.

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np


def time_axis(config: dict) -> np.ndarray:
    """(n_time,) float64 seconds."""
    return np.arange(config["n_time"]) / config["sw_hz"]


def spectral_constants(config: dict):
    """``(weight, freqs)``, float32 (zero_fill,): the lb window on the
    zero-filled axis and the centred frequency axis, as ``make_inputs``
    returns them."""
    n_out, sw = config["zero_fill"], config["sw_hz"]
    t_full = np.arange(n_out) / sw
    weight = np.exp(-np.pi * config["lb_hz"] * t_full).astype(np.float32)
    freqs = np.fft.fftshift(np.fft.fftfreq(n_out, d=1.0 / sw)).astype(np.float32)
    return weight, freqs


def _peak_signals(config: dict, g: float):
    """Each peak's unit complex128 signal over the time axis, as
    ``make_inputs`` computes it."""
    t = time_axis(config)
    mhz = config["mhz"]
    out = []
    for p in config["peaks"]:
        shift, lw = p["shift_ppm"], p["linewidth_hz"]
        if g:
            sig = (np.exp(-lw * np.pi * (1 - g + g * t) * t)
                   * np.exp(1j * 2 * np.pi * (shift * mhz) * t))
        else:
            sig = np.exp((-lw * np.pi + 1j * 2 * np.pi * (shift * mhz)) * t)
        out.append(sig)
    return out


def fid_grid(config: dict, grid_seed: int, device, noise_scale: float = 1.0,
             g: float | None = None):
    """One grid of FIDs as float32 planes ``(re, im)``, each (B, n_time),
    on ``device``.  At ``grid_seed`` 0, the config's grid, ``noise_scale``
    1 and ``g`` 0 it equals ``bench_inputs.make_inputs()[0]`` bit for bit."""
    import torch

    b = int(np.prod(config["grid"]))
    n = config["n_time"]
    g = config["g"] if g is None else g
    rng = np.random.default_rng(grid_seed)
    lo, hi = config["pcr_amplitude_range"]
    amp_var = rng.uniform(lo, hi, size=b)
    f64 = dict(dtype=torch.float64, device=device)
    re = torch.zeros((b, n), **f64)
    im = torch.zeros((b, n), **f64)
    amp_t = torch.as_tensor(amp_var, **f64)[:, None]
    for p, sig in zip(config["peaks"], _peak_signals(config, g)):
        s_re = torch.as_tensor(np.ascontiguousarray(sig.real), **f64)[None, :]
        s_im = torch.as_tensor(np.ascontiguousarray(sig.imag), **f64)[None, :]
        amp = amp_t if p["amplitude"] is None else p["amplitude"]
        re = re + amp * s_re
        im = im + amp * s_im
    sigma = config["noise_sigma"] * noise_scale
    re = re + torch.as_tensor(rng.normal(0, sigma, (b, n)), **f64)
    im = im + torch.as_tensor(rng.normal(0, sigma, (b, n)), **f64)
    return re.to(torch.float32), im.to(torch.float32)


# ---------------------------------------------------------------------------
# Coil maps and k-space (``bench_inputs.coil_sensitivities`` and
# ``unit_rss_coil_maps``, the benchmark's copy)
# ---------------------------------------------------------------------------


def scaled_grid(shape):
    big = max(shape)
    return [g * (big / n) for g, n in zip(np.mgrid[tuple(slice(0, n) for n in shape)],
                                           shape)], big


def coil_maps(config: dict) -> np.ndarray:
    """(n_coils, *grid) complex128 unit-RSS maps: Gaussian blobs of width
    ``width`` L at uniformly drawn centres with a uniform random phase,
    drawn from the config's seed."""
    spec = config["coil_maps"]
    shape = tuple(config["grid"])
    rng = np.random.default_rng(spec["seed"])
    axes, big = scaled_grid(shape)
    coils = []
    for _ in range(config["n_coils"]):
        centre = rng.uniform(0, big, len(shape))  # the last axis first
        d2 = sum((axes[a] - centre[len(shape) - 1 - a]) ** 2
                 for a in reversed(range(len(shape))))
        sens = np.exp(-(d2 / (2 * (big * spec["width"]) ** 2)))
        coils.append(sens * np.exp(1j * rng.uniform(0, 2 * np.pi)))
    sens = np.stack(coils)
    return sens / np.sqrt(np.sum(np.abs(sens) ** 2, axis=0, keepdims=True))


def coil_kspace(config: dict, re, im, maps):
    """Centered k-space ``(coil, kx, ky, kz, time)`` complex64 of the FID
    planes times the coil maps: ``fftshift(fftn(ifftshift(.), ortho))``
    over the spatial axes, on the planes' device, in complex64."""
    import torch

    grid = tuple(config["grid"])
    fids = torch.complex(re, im).reshape(grid + (config["n_time"],))
    maps_t = torch.as_tensor(maps.astype(np.complex64), device=re.device)
    sp = (1, 2, 3)
    img = maps_t[..., None] * fids[None]
    del fids
    ksp = torch.fft.fftshift(torch.fft.fftn(torch.fft.ifftshift(img, dim=sp),
                                            dim=sp, norm="ortho"), dim=sp)
    return ksp.contiguous()


def make_pool(config: dict, mix: dict, seed: int, device):
    """The cell's pool: ``mix["pool"]`` grids, each a dict with ``seed`` and
    the FID planes ``re``/``im`` (B, n_time) float32, or, for a config with
    coils, ``kspace`` (coil, kx, ky, kz, time) complex64 and the shared
    ``maps`` (numpy complex128)."""
    stride = int(mix.get("seed_stride", 16))
    maps = coil_maps(config) if config.get("n_coils") else None
    pool = []
    for i in range(int(mix["pool"])):
        s = int(seed) * stride + i
        re, im = fid_grid(config, s, device, mix.get("noise_scale", 1.0),
                          mix.get("g"))
        if maps is None:
            pool.append({"seed": s, "re": re, "im": im})
        else:
            pool.append({"seed": s, "kspace": coil_kspace(config, re, im, maps),
                         "maps": maps})
            del re, im
    return pool
