# Hand-written Hopper kernels, each beside its plain PyTorch version:
#   maestro_eval     the paper's DSE inner loop (design points -> features),
#                    CUDA C++ in maestro_eval/csrc
