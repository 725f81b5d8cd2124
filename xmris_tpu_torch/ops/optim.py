"""Differential evolution with a gradient polish (PyTorch port).

Port of :mod:`xmris_tpu.ops.optim`: best1bin differential evolution as
scipy defines it — population ``max(popsize * n_params, 5)`` in unit space,
stratified (Latin-hypercube) initialisation, the mutation factor dithered
per generation in ``mutation``, binomial crossover at ``recombination``
with one guaranteed mutant dimension, greedy selection (so a candidate of
energy ``+inf`` never replaces a finite member), and convergence when
``std(energies) <= atol + tol * |mean(energies)|`` — then an optional
backtracking gradient polish of the best member (:func:`_polish`, gradients
from ``torch.autograd``).

The population is one tensor and the objective is called on all of it at
once.  :func:`differential_evolution_batched` runs one independent search
per row of a batch (the reference's ``vmap`` over split keys): each row
stops on its own convergence test, and a generation evaluates only the rows
still running.  Randomness comes from one explicit ``torch.Generator`` on
the search's device, seeded from ``seed``; the reference draws from
``jax.random``, so the two packages' draws differ and agree only in the
objective they reach.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from xmris_tpu_torch.core.utils import card_device


class DEResult(NamedTuple):
    x: torch.Tensor  # best parameters, (n_params,) or (V, n_params)
    fun: torch.Tensor  # best energy, () or (V,)
    nit: torch.Tensor  # generations executed, () or (V,)
    converged: torch.Tensor  # bool, () or (V,)


def _generator(seed, device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def _as_bounds(bounds, device, dtype):
    b = torch.as_tensor(bounds, device=device)
    if dtype is None:
        dtype = b.dtype if b.is_floating_point() else torch.float32
    return b.to(dtype)


def differential_evolution_batched(
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    bounds,
    n_batch: int,
    seed: int | torch.Generator = 42,
    popsize: int = 15,
    maxiter: int = 1000,
    tol: float = 0.01,
    atol: float = 0.0,
    mutation: tuple[float, float] = (0.5, 1.0),
    recombination: float = 0.7,
    polish_iters: int = 0,
    device=None,
    dtype=None,
) -> DEResult:
    """``n_batch`` independent best1bin searches over the same box.

    ``fn(x, rows)`` takes candidates ``x`` (A, n, n_params) in physical
    units for the batch rows ``rows`` (A,) (a long tensor) and returns
    their energies (A, n).  ``bounds`` is (n_params, 2).  The search runs
    on ``device``; by default on ``bounds``'s device where it is a tensor,
    else on the card.  Every generation
    draws its random numbers for all ``n_batch`` rows, so a row's draws do
    not depend on when the others converge.  Returns a :class:`DEResult`
    of (V, n_params), (V,), (V,) and (V,) tensors.
    """
    if device is None:
        device = bounds.device if isinstance(bounds, torch.Tensor) else "cuda"
    card_device(device, "differential evolution")
    bounds = _as_bounds(bounds, device, dtype)
    dev, dt = bounds.device, bounds.dtype
    gen = _generator(seed, dev)
    n_params = bounds.shape[0]
    n_pop = max(popsize * n_params, 5)
    lower, span = bounds[:, 0], bounds[:, 1] - bounds[:, 0]
    all_rows = torch.arange(n_batch, device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=dt)

    def randint(high, *shape):
        return torch.randint(high, shape, generator=gen, device=dev)

    def energy(u, rows):
        return fn(lower + u * span, rows)

    def converged(e):
        return e.std(dim=-1, correction=0) <= atol + tol * e.mean(dim=-1).abs()

    with torch.no_grad():
        # Stratified init: one sample per stratum, each dimension's strata
        # permuted independently.
        strata = (torch.arange(n_pop, device=dev, dtype=dt)[None, :, None]
                  + rand(n_batch, n_pop, n_params)) / n_pop
        perm = torch.argsort(rand(n_batch, n_pop, n_params), dim=1)
        pop = strata.gather(1, perm)
        energies = energy(pop, all_rows)
        nit = torch.zeros(n_batch, dtype=torch.long, device=dev)
        active = ~converged(energies)
        lanes = torch.arange(n_params, device=dev)
        for _ in range(maxiter):
            if not bool(active.any()):
                break
            f = mutation[0] + (mutation[1] - mutation[0]) * rand(n_batch)
            r1 = randint(n_pop, n_batch, n_pop)
            r2 = randint(n_pop, n_batch, n_pop)
            cross = rand(n_batch, n_pop, n_params)
            fill = randint(n_params, n_batch, n_pop)
            rows = active.nonzero()[:, 0]
            p, e = pop[rows], energies[rows]
            best = p.gather(1, e.argmin(1)[:, None, None].expand(-1, 1, n_params))

            def pick(r):
                return p.gather(1, r[rows][:, :, None].expand(-1, -1, n_params))

            mutants = best + f[rows, None, None] * (pick(r1) - pick(r2))
            take = (cross[rows] < recombination) | (
                lanes[None, None, :] == fill[rows][:, :, None])
            trials = torch.clamp(torch.where(take, mutants, p), 0.0, 1.0)
            e_t = energy(trials, rows)
            improved = e_t < e
            pop[rows] = torch.where(improved[:, :, None], trials, p)
            energies[rows] = torch.where(improved, e_t, e)
            nit[rows] += 1
            active = active & ~converged(energies) & (nit < maxiter)

        best_idx = energies.argmin(1)
        x_unit = pop[all_rows, best_idx]
        fun = energies[all_rows, best_idx]
        done = converged(energies)
    if polish_iters > 0:
        x_unit, fun = _polish(energy, all_rows, x_unit, fun, polish_iters)
    return DEResult(x=lower + x_unit * span, fun=fun, nit=nit, converged=done)


def _polish(energy, rows, x_unit, fun, iters: int):
    """Backtracking gradient descent in unit space, the box kept by
    clipping: a step ``x - lr g`` is taken when it lowers the energy (lr
    x1.2), else lr halves; lr starts at 1e-2.  Each row on its own."""
    def value_and_grad(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            e = energy(xr[:, None, :], rows)[:, 0]
            (g,) = torch.autograd.grad(e.sum(), xr)
        return e.detach(), g

    _, g = value_and_grad(x_unit)
    lr = torch.full_like(fun, 1e-2)
    x, f = x_unit, fun
    for _ in range(iters):
        x_new = torch.clamp(x - lr[:, None] * g, 0.0, 1.0)
        f_new, g_new = value_and_grad(x_new)
        better = f_new < f
        x = torch.where(better[:, None], x_new, x)
        f = torch.where(better, f_new, f)
        g = torch.where(better[:, None], g_new, g)
        lr = torch.where(better, lr * 1.2, lr * 0.5)
    return x, f


def differential_evolution(
    fn: Callable[[torch.Tensor], torch.Tensor],
    bounds,
    seed: int | torch.Generator = 42,
    popsize: int = 15,
    maxiter: int = 1000,
    tol: float = 0.01,
    atol: float = 0.0,
    mutation: tuple[float, float] = (0.5, 1.0),
    recombination: float = 0.7,
    polish_iters: int = 0,
    device=None,
    dtype=None,
) -> DEResult:
    """Minimize ``fn`` over the box ``bounds`` (n_params, 2) with best1bin
    differential evolution (reference ``differential_evolution``).

    ``fn`` maps a batch of candidates (n, n_params) to their energies (n,);
    the whole population goes through one call.  ``seed`` is an int or a
    ``torch.Generator``; ``polish_iters > 0`` polishes the best member
    (:func:`_polish`).  The search runs on ``device``: by default on
    ``bounds``'s device where it is a tensor, else on the card (pass
    ``device="cpu"`` to search on the host).  It computes in ``bounds``'s
    floating type (float32 for other bounds).  Returns
    a :class:`DEResult` with ``x`` (n_params,) and 0-dim ``fun``, ``nit``
    and ``converged``.
    """
    res = differential_evolution_batched(
        lambda x, rows: fn(x[0])[None], bounds, 1, seed=seed,
        popsize=popsize, maxiter=maxiter, tol=tol, atol=atol,
        mutation=mutation, recombination=recombination,
        polish_iters=polish_iters, device=device, dtype=dtype,
    )
    return DEResult(*(v[0] for v in res))


def differential_evolution_jit(
    fn, bounds, seed=42, popsize=15, maxiter=1000, tol=0.01, polish_iters=0,
    device=None,
) -> DEResult:
    """The reference's jitted convenience wrapper, with its defaults: here
    the same call as :func:`differential_evolution` (nothing to compile)."""
    return differential_evolution(
        fn, bounds, seed=seed, popsize=popsize, maxiter=maxiter, tol=tol,
        polish_iters=polish_iters, device=device,
    )
