"""GNN family of the port (mirrors ``repro.models.gnn``): EGNN, DimeNet,
MACE and GraphCast over padded edge lists (``common.GraphBatch``). The
owner-partitioned DimeNet (``partitioned.py`` there) is not ported yet."""
