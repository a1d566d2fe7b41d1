"""Pluggable file IO (reference VirtualFileReader/VirtualFileWriter,
src/io/file_io.cpp + utils/file_io.h, incl. the optional HDFS backend
behind USE_HDFS).

The port's copy of lightgbm_tpu/utils/file_io.py. Local paths use plain
open(). URI-style paths (scheme://...) dispatch to a registered handler;
`fsspec` is used when importable (which covers hdfs/s3/gs/... the way
the reference's HDFS build does), and custom schemes can be registered
explicitly:

    lightgbm_tpu_torch.utils.file_io.register_filesystem("myfs", opener)

where `opener(path, mode)` returns a file object. Model files, binary
dataset caches and the CLI's reads and writes go through open_file()."""

from __future__ import annotations

from typing import Callable, Dict

__all__ = ["open_file", "register_filesystem"]

_SCHEMES: Dict[str, Callable] = {}


def register_filesystem(scheme: str, opener: Callable) -> None:
    """Register `opener(path, mode)` for `scheme://` paths."""
    _SCHEMES[scheme] = opener


def _scheme_of(path) -> str:
    s = str(path)
    if "://" in s:
        return s.split("://", 1)[0]
    return ""


def open_file(path, mode: str = "r"):
    """open() for local paths; registered handler or fsspec for URIs."""
    scheme = _scheme_of(path)
    if not scheme:
        return open(path, mode)
    if scheme in _SCHEMES:
        return _SCHEMES[scheme](str(path), mode)
    try:
        import fsspec
    except ImportError:
        raise ValueError(
            f"no filesystem registered for scheme {scheme!r} and fsspec "
            f"is not installed; register one with "
            f"lightgbm_tpu_torch.utils.file_io.register_filesystem") \
            from None
    try:
        return fsspec.open(str(path), mode).open()
    except (ValueError, ImportError) as e:
        raise ValueError(
            f"no filesystem registered for scheme {scheme!r} and fsspec "
            f"cannot handle it ({e}); register one with "
            f"lightgbm_tpu_torch.utils.file_io.register_filesystem") from e
