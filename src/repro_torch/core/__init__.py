"""The paper's algorithm on torch tensors: losses, sampling, the SODDA
step, the backend engine and the run driver."""
