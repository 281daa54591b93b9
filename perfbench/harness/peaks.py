"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates
without sparsity, at the card's full 700 W: NVIDIA's data sheet.  Every
roofline share and every ``mfu`` of the benchmark is taken against these
numbers, with the card's power limit printed beside the run."""

BF16_FLOPS = 989e12        # tensor cores, bf16 and fp16 in
F32_FLOPS = 67e12          # CUDA cores, f32 outside the tensor cores
HBM_BYTES_S = 3.35e12      # HBM3
L2_BYTES = 50 * 2 ** 20    # last-level cache

PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
              "float32": F32_FLOPS}
