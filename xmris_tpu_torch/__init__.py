"""xmris_tpu_torch: the PyTorch/CUDA port of xmris_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``xmris_tpu``, with the same
module paths and public names.  It imports torch, numpy and scipy, never
jax; its hand-written CUDA kernels (``ops/kernels/csrc``) build on first use
on a machine with nvcc and an sm_90 card, and every kernel has a plain
PyTorch twin that runs on CPU tensors.

The ported surface is the reference's labeled layer and everything under
it: the ``.xmr`` accessor chain on :class:`XmrArray`, the op functions,
``simulate_fid``, ``fit_amares``, the fused per-grid program
(:func:`xmris_tpu_torch.parallel.process.process_grid_planar_raw`) and
``mrsi_pipeline``, each also over a voxel mesh
(:mod:`xmris_tpu_torch.parallel`), k-space recon
(:mod:`xmris_tpu_torch.recon`), Bruker ingest, the file formats, and the
runtime layer (:mod:`xmris_tpu_torch.runtime`: precision defaults,
profiling, the ``xmris-tpu-torch-fit`` / ``-recon`` / ``-serve`` console
scripts), and the visualization (:mod:`xmris_tpu_torch.visualization`:
plots, widgets and their browser engines, on the optional matplotlib and
traitlets, which only drawing imports).  Entry points that search or fit
run on the card unless the caller passes ``device="cpu"``; transforms run
where the payload lies.
"""

# --- Submodules -------------------------------------------------------------
from xmris_tpu_torch import config, core, fitting, models, ops, processing, runtime, vendor

# --- 1. Vocabulary singletons -----------------------------------------------
from xmris_tpu_torch.core import ATTRS, COORDS, DIMS, VARS

# --- 2. The labeled carrier + accessors --------------------------------------
from xmris_tpu_torch.core.accessor import XmrisAccessor, XmrisDatasetAccessor
from xmris_tpu_torch.core.array import Coord, XmrArray, XmrDataset

# --- 3. Core signal processing & utilities ----------------------------------
from xmris_tpu_torch.ops.baseline import baseline_als
from xmris_tpu_torch.ops.fid import apodize_exp, apodize_lg, to_fid, to_spectrum, zero_fill
from xmris_tpu_torch.ops.fourier import fft, fftc, fftshift, ifft, ifftc, ifftshift
from xmris_tpu_torch.ops.phasing import autophase, phase
from xmris_tpu_torch.ops.utils import to_complex, to_real_imag

# --- 4. Modeling & fitting ---------------------------------------------------
from xmris_tpu_torch.fitting.simulation import simulate_fid

# --- 5. Vendor integrations --------------------------------------------------
from xmris_tpu_torch.vendor.bruker import remove_digital_filter

# --- 6. Optional xarray interop ----------------------------------------------
from xmris_tpu_torch.interop.xarray import register_xarray_accessors

__version__ = "0.1.0"

register_xarray_accessors()


def __getattr__(name):
    # Heavier layers resolve lazily to keep `import xmris_tpu_torch` light.
    if name == "fit_amares":
        from xmris_tpu_torch.fitting.amares import fit_amares

        return fit_amares
    if name == "DEFAULTS":
        from xmris_tpu_torch.config import DEFAULTS

        return DEFAULTS
    if name in ("WaterfallConfig", "CarpetConfig", "PlotTrajectoryConfig", "PlotQCGridConfig"):
        from xmris_tpu_torch import visualization

        return getattr(visualization.plot, name)
    if name in ("visualization", "parallel", "recon"):
        import importlib

        return importlib.import_module(f"xmris_tpu_torch.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    # --- Submodules ---
    "core",
    "config",
    "fitting",
    "models",
    "ops",
    "processing",
    "parallel",
    "recon",
    "runtime",
    "vendor",
    "visualization",
    # --- 1. Config & singletons ---
    "ATTRS",
    "COORDS",
    "DIMS",
    "VARS",
    "DEFAULTS",
    # --- 2. Carrier & accessors ---
    "Coord",
    "XmrArray",
    "XmrDataset",
    "XmrisAccessor",
    "XmrisDatasetAccessor",
    # --- 3. Core processing & utilities ---
    "to_complex",
    "to_real_imag",
    "apodize_exp",
    "apodize_lg",
    "to_fid",
    "to_spectrum",
    "zero_fill",
    "fft",
    "fftc",
    "fftshift",
    "ifft",
    "ifftc",
    "ifftshift",
    "autophase",
    "phase",
    "baseline_als",
    # --- 4. Fitting ---
    "fit_amares",
    "simulate_fid",
    # --- 5. Vendor ---
    "remove_digital_filter",
    # --- 6. Visualization configs ---
    "WaterfallConfig",
    "CarpetConfig",
    "PlotTrajectoryConfig",
    "PlotQCGridConfig",
    # --- Interop ---
    "register_xarray_accessors",
]
