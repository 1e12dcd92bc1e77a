"""hand-written Pallas kernels for the GPU (Triton route); the XLA
formulations they replace live one level up and stay the reference"""
