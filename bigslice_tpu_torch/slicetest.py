"""Test conveniences: run a slice in a session and scan its rows.

``session`` defaults to ``Session()``, the device executor on ``cuda``;
tests on the CPU pass a session of their own (``Session(executor=
MeshExecutor(device="cpu"))`` or ``LocalExecutor(device="cpu")``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from bigslice_tpu_torch.exec.session import Result, Session


def run(func_or_slice: Any, *args,
        session: Optional[Session] = None) -> Result:
    sess = session or Session()
    return sess.run(func_or_slice, *args)


def scan_all(func_or_slice: Any, *args,
             session: Optional[Session] = None) -> List[Tuple]:
    return run(func_or_slice, *args, session=session).rows()


def sorted_rows(func_or_slice: Any, *args,
                session: Optional[Session] = None) -> List[Tuple]:
    """Rows in a deterministic (sorted) order, for assertions: shard and
    partition order mean nothing."""
    return sorted(scan_all(func_or_slice, *args, session=session),
                  key=_row_key)


def _row_key(row: Tuple):
    return tuple(
        (str(type(v)), v) if not isinstance(v, (list, tuple)) else
        (str(type(v)), tuple(v)) for v in row
    )
