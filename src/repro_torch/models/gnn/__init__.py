"""GNN family of the port (mirrors ``repro.models.gnn``): EGNN, DimeNet,
MACE and GraphCast over padded edge lists (``common.GraphBatch``), and
the owner-partitioned DimeNet block over ``torch.distributed``
(``partitioned.py``)."""
