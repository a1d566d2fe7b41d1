"""CLI for the observability toolbox.

Port of lightgbm_tpu/observability/__main__.py.

Subcommands:

``merge <dir> [-o OUT]``
    Merge every rank-tagged Perfetto trace under <dir> (the chrome
    dumps each rank writes via ``observe_trace_file``) into one
    clock-aligned trace with ``pid = rank`` and per-collective skew
    instants (observability/merge.py). Exit code 0 on success, 1 when
    the merge fails (no rank-tagged trace), 2 on a usage error.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from .merge import merge_directory, merge_summary

USAGE = ("usage: python -m lightgbm_tpu_torch.observability "
         "merge <trace_dir> [-o OUT]")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd != "merge":
        print(f"unknown command {cmd!r}\n{USAGE}", file=sys.stderr)
        return 2
    out = None
    if "-o" in rest:
        i = rest.index("-o")
        if i + 1 >= len(rest):
            print(f"-o needs a path\n{USAGE}", file=sys.stderr)
            return 2
        out = rest[i + 1]
        del rest[i:i + 2]
    if len(rest) != 1:
        print(USAGE, file=sys.stderr)
        return 2
    try:
        path, merged = merge_directory(rest[0], out=out)
    except (ValueError, OSError) as exc:
        print(f"merge failed: {exc}", file=sys.stderr)
        return 1
    print(f"wrote {path}")
    print(merge_summary(merged))
    return 0


if __name__ == "__main__":
    sys.exit(main())
