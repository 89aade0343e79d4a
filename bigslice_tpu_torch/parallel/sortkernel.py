"""Device run sort: a stable sort of whole frames by their key prefix.

The one sort of ``parallel/segment.py`` (``sort_with_payload``) over a
frame's columns on the frame's own device: keys ordered as the JAX
package's ``lax.sort`` orders them (-0.0 and +0.0 equal, NaN last, ties
in input order), every other column gathered along.
"""

from __future__ import annotations


def device_sortable(frame) -> bool:
    """A frame the device sort serves: a key prefix and scalar device
    columns only."""
    return frame.prefix >= 1 and all(
        ct.is_device and ct.shape == () for ct in frame.schema)


def device_sorted_by_key(frame):
    """``frame`` stably sorted by its key prefix, on its device."""
    from bigslice_tpu_torch.frame.frame import Frame
    from bigslice_tpu_torch.parallel.segment import sort_with_payload

    keys, vals = sort_with_payload(frame.key_cols(), frame.prefix,
                                   frame.value_cols())
    return Frame(list(keys) + list(vals), frame.schema)
