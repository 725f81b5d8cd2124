"""K1's FFT route, checked where there is no card.

The CUDA kernel (``csrc/spectrum.cu::spectrum_fft_kernel``) runs only on
the card (``test_torch_cuda.py`` holds it against ``spectrum_plain`` there).
Here the pieces its plan rests on are pinned on the CPU:

* ``dft_cuda.route``: which of K1's two kernels a shape takes;
* ``dft_cuda.fft_plan``: the pass radices, in the kernel's order;
* ``dft_cuda.fft_twiddles``: the float32 table against
  ``numpy.exp(-2j pi k / n)`` to 1e-7;
* the kernel's index algebra, run in NumPy: the load (window and
  1/sqrt(n) folded, zero-fill), the Stockham passes over the same table in
  the same order with the same thread-to-butterfly map, the fftshifted
  store and the first-index peak, against ``numpy.fft`` and against
  ``spectrum_plain`` at 1e-6 of max|S|.
"""

import numpy as np
import pytest
import torch

from xmris_tpu_torch.ops.kernels import dft_cuda


@pytest.mark.parametrize("n_in,n_out,want", [
    (256, 512, "fft"), (1024, 1024, "fft"), (1024, 2048, "fft"),
    (512, 2048, "fft"), (4096, 4096, "fft"), (4096, 8192, "fft"),
    (768, 1536, "split"), (96, 192, "split"), (64, 128, "split"),
    (8192, 16384, "split"), (1000, 2000, "split"),
])
def test_route(n_in, n_out, want):
    assert dft_cuda.route(n_in, n_out) == want


@pytest.mark.parametrize("n,plan", [
    (256, (8, 8, 4)), (512, (8, 8, 8)), (1024, (8, 8, 8, 2)),
    (2048, (8, 8, 8, 4)), (4096, (8, 8, 8, 8)), (8192, (8, 8, 8, 8, 2)),
])
def test_fft_plan(n, plan):
    assert dft_cuda.fft_plan(n) == plan
    assert int(np.prod(plan)) == n


@pytest.mark.parametrize("n", [256, 2048, 8192])
def test_fft_twiddles(n):
    c, s = dft_cuda.fft_twiddles(n)
    assert c.dtype == s.dtype == np.float32 and c.shape == s.shape == (n,)
    want = np.exp(-2j * np.pi * np.arange(n) / n)
    np.testing.assert_allclose(c, want.real, rtol=0, atol=1e-7)
    np.testing.assert_allclose(s, want.imag, rtol=0, atol=1e-7)
    # The quarter turns are exact, so multiplying by them is exact.
    for k, (cr, ci) in {0: (1, 0), n // 4: (0, -1), n // 2: (-1, 0),
                        3 * n // 4: (0, 1)}.items():
        assert (c[k], s[k]) == (cr, ci)


def _dft_small(v):
    return np.fft.fft(v, axis=-1)


def _kernel_in_numpy(xr, xi, window, n_out):
    """The FFT kernel's arithmetic plan in NumPy (complex128 over the
    float32 table): returns (re, im, maxmag, maxidx) as the kernel stores
    them."""
    b, n_in = xr.shape
    c, s = dft_cuda.fft_twiddles(n_out)
    tw = c.astype(np.float64) + 1j * s.astype(np.float64)
    scale = np.float32(1.0 / np.sqrt(n_out))
    buf = np.zeros((b, n_out), np.complex128)
    buf[:, :n_in] = (xr + 1j * xi) * (window * scale)
    t_per = n_out // 8
    ns = 1
    plan = dft_cuda.fft_plan(n_out)
    out = np.empty_like(buf)
    best = np.full(b, -np.inf)
    best_i = np.full(b, np.iinfo(np.int32).max)
    for p, r_ in enumerate(plan):
        nxt = np.empty_like(buf)
        for j in range(t_per):  # thread j owns butterflies j + q n/8
            for q in range(8 // r_):
                jb = j + q * t_per
                k = jb % ns
                step = k * (n_out // (ns * r_))
                idx = jb + np.arange(r_) * (n_out // r_)
                v = buf[:, idx] * tw[np.arange(r_) * step]
                v = _dft_small(v)
                dst = (jb // ns) * ns * r_ + k + np.arange(r_) * ns
                if p < len(plan) - 1:
                    nxt[:, dst] = v
                else:  # the last pass: shifted store and the peak
                    sdx = (dst + n_out // 2) % n_out
                    out[:, sdx] = v
                    for r in range(r_):
                        m2 = np.abs(v[:, r]) ** 2
                        take = (m2 > best) | ((m2 == best) & (sdx[r] < best_i))
                        best = np.where(take, m2, best)
                        best_i = np.where(take, sdx[r], best_i)
        buf = nxt
        ns *= r_
    return out.real, out.imag, best, best_i


@pytest.mark.parametrize("n_in,n_out", [(256, 512), (1024, 2048), (512, 2048),
                                        (1024, 1024)])
def test_fft_index_algebra_in_numpy(n_in, n_out):
    rng = np.random.default_rng(n_out + n_in)
    xr = rng.normal(size=(3, n_in)).astype(np.float32)
    xi = rng.normal(size=(3, n_in)).astype(np.float32)
    window = rng.uniform(0.5, 1.0, n_in).astype(np.float32)
    re, im, mv, mi = _kernel_in_numpy(xr, xi, window, n_out)
    want = np.fft.fftshift(np.fft.fft((xr + 1j * xi) * window, n=n_out,
                                      norm="ortho"), axes=-1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(re, want.real, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(im, want.imag, rtol=0, atol=1e-6 * scale)
    plain = dft_cuda.spectrum_plain(torch.from_numpy(xr), torch.from_numpy(xi),
                                    n_out, window=torch.from_numpy(window),
                                    with_maxmag=True)
    np.testing.assert_allclose(re, plain[0].numpy(), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(im, plain[1].numpy(), rtol=0, atol=1e-6 * scale)
    np.testing.assert_array_equal(mi, plain[3].numpy())
    np.testing.assert_allclose(mv, plain[2].numpy(), rtol=1e-5)
