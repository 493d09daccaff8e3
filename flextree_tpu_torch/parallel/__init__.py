"""The train step (``train``), the GPipe step (``pipeline``), the MoE step
(``moe_train``), the run loop (``loop``) and the
local-attention switch (``ring_attention``); the FlexTree collectives
(``allreduce``), the in-process mesh of ranks (``mesh``) and process
bring-up on ``torch.distributed`` (``launch``).  Import by module path."""
