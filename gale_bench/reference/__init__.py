"""Plain PyTorch references of the benchmark's configurations: the decoder
stack (:mod:`.lm`), each family's feed-forward block (``dense_block``,
``granite_moe_block``), AdamW (:mod:`.adamw`) and the precisions they
compute in (:mod:`.precision`). Nothing here imports the program."""
