"""Model families of the port: the decoder-only transformer (dense and
MoE), the GNN family (``gnn/``) and the wide-deep recommender
(``recsys``)."""
