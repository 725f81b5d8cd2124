"""Core layer of the PyTorch port: vocabulary, validation, the labeled-array
carrier, accessors."""

from xmris_tpu_torch.core.array import Coord, XmrArray, XmrDataset
from xmris_tpu_torch.core.config import (
    ATTRS,
    COORDS,
    DIMS,
    VARS,
    BaseVocabulary,
    XmrisAttributes,
    XmrisCoordinates,
    XmrisDataVars,
    XmrisDimensions,
    XmrisTerm,
    XmrTerm,
)
from xmris_tpu_torch.core.utils import as_coord, check_dims
from xmris_tpu_torch.core.validation import requires_attrs

__all__ = [
    "ATTRS",
    "COORDS",
    "DIMS",
    "VARS",
    "BaseVocabulary",
    "Coord",
    "XmrArray",
    "XmrDataset",
    "XmrTerm",
    "XmrisTerm",
    "XmrisAttributes",
    "XmrisCoordinates",
    "XmrisDataVars",
    "XmrisDimensions",
    "as_coord",
    "check_dims",
    "requires_attrs",
]
