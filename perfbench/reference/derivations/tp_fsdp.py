"""Tensor parallel over the mesh's "model" axis × ZeRO-3 data parallel
over its "data" axis: the frozen `step_collective_ops` of
`reference/collective_ops.py`, the default derivation, with the default
flows (each op's mesh axis mapped onto the placement)."""
from ..collective_ops import CollectiveOp, step_collective_ops

__all__ = ["CollectiveOp", "step_collective_ops"]
