"""Plain PyTorch references of the port's computations, for tests and the
benchmark to hold the port to. Each imports nothing of the port, of the JAX
package or of JAX."""
