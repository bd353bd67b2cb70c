# Hand-written Hopper kernels, each beside its plain PyTorch version:
#   maestro_eval     the paper's DSE inner loop (design points -> features),
#                    CUDA C++ in maestro_eval/csrc
#   flash_attention  causal/bidirectional GQA attention with an online
#                    softmax, CUDA C++ in flash_attention/csrc
#   linear_scan      the chunked RWKV-6 / Mamba-2 recurrence, CUDA C++ in
#                    linear_scan/csrc
# _build compiles each source with nvcc and loads it with ctypes.
