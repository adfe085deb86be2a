"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense rates,
no sparsity, at its full 700 W power limit; a card set below that limit runs
slower under load), and of the links of a DGX H100 node.  The one home of these numbers: the dry-run's roofline
(``launch.dryrun``), ``chip_smoke.py``'s kernel bounds, the route probe and
the examples' weight-stream projections all read them here."""

BF16_FLOPS = 989e12            # FLOP/s, bf16 / fp16 tensor cores
F32_FLOPS = 67e12              # FLOP/s, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12      # HBM3
NVLINK_BYTES_PER_S = 450e9     # NVLink 4, per direction
#: between nodes of 8 cards: one 400 Gb/s NDR InfiniBand port per card
#: (NVIDIA's DGX H100 data sheet: 8 x ConnectX-7 at 400 Gb/s), per direction
INTERNODE_BYTES_PER_S = 50e9
CARDS_PER_NODE = 8

#: peak FLOP/s by the operands' dtype, keyed by ``str(torch dtype)``
PEAK_FLOPS = {"torch.bfloat16": BF16_FLOPS, "torch.float32": F32_FLOPS}
