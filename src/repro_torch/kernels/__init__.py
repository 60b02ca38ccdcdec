"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``) and the device-dispatching entry points (``ops``)."""
