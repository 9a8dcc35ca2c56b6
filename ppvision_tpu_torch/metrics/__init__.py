"""Evaluation metrics of the port: RAFT temporal flow consistency."""

from .temporal import flow_consistency, make_flow_consistency_fn

__all__ = ["flow_consistency", "make_flow_consistency_fn"]
