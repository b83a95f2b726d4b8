"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A card set below
that limit runs slower under load: every run prints its `power.limit`
beside the shares taken against these."""

TENSOR_OPS_PER_S = {          # dense tensor-core rates by operand type
    "int8": 1979e12,
    "bf16": 989e12,
}
FP32_OPS_PER_S = 67e12        # float32 outside the tensor cores
MEM_BYTES_PER_S = 3.35e12     # HBM3
SFU_PER_SM_PER_CLOCK = 16     # exp2 (MUFU) results per SM per clock on Hopper
