"""Validation decorators: runtime attr checks + import-time docstring injection.

Port of ``xmris_tpu.core.validation``.  The "bouncer"
pattern: methods that need physical metadata (e.g. ``reference_frequency`` for
ppm conversion) declare it declaratively; missing attrs raise an actionable
``ValueError`` containing a copy-pasteable fix, and the requirement list is
appended to the method docstring at import time.
"""

from __future__ import annotations

import functools
from collections.abc import Callable

from xmris_tpu_torch.core.config import ATTRS

_SECTION_TITLE = "Required Attributes"


def _requirements_section(keys: tuple[str, ...]) -> str:
    """Render a NumPy-style docstring section describing required attrs.

    One bullet per key, with its description pulled live from the vocabulary
    singleton so docs can never drift from the data dictionary.
    """
    header = [f"    {_SECTION_TITLE}", "    " + "-" * len(_SECTION_TITLE)]
    bullets = [f"    * ``{key}``: {ATTRS.get_description(key)}" for key in keys]
    return "\n".join(header + bullets) + "\n"


def _merge_docstring(original: str | None, section: str) -> str:
    """Splice the requirements section after the existing docstring body."""
    if not original:
        return section
    if original.endswith("\n\n"):
        glue = ""
    elif original.endswith("\n"):
        glue = "\n"
    else:
        glue = "\n\n"
    return original + glue + section


def _missing_attrs(attrs, keys: tuple[str, ...]) -> list[str]:
    return [key for key in keys if key not in attrs]


def requires_attrs(*keys: str) -> Callable:
    """Enforce that specific keys exist in ``self._obj.attrs`` at call time.

    Raises a ``ValueError`` with explicit fix instructions when attributes are
    missing, and injects a "Required Attributes" docstring section at import
    time so documentation stays in sync with runtime behavior.
    """
    required = tuple(keys)

    def decorator(func: Callable) -> Callable:
        @functools.wraps(func)
        def wrapper(self, *args, **kwargs):
            absent = _missing_attrs(self._obj.attrs, required)
            if absent:
                raise ValueError(
                    f"Method '{func.__name__}' requires the following missing attributes "
                    f"in `obj.attrs`: {absent}.\n\n"
                    f"To fix this, assign them using standard methods:\n"
                    f"    >>> obj = obj.assign_attrs({{{absent[0]!r}: value}})"
                )
            return func(self, *args, **kwargs)

        # functools.wraps copied the original docstring; extend it in place on
        # the wrapper (the object actually exposed on the class).
        wrapper.__doc__ = _merge_docstring(
            func.__doc__, _requirements_section(required)
        )
        return wrapper

    return decorator
