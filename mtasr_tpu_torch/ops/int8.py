"""The one constant every int8 quantizer of the port shares.

The JAX package divides by 127 (`max|x| / 127.0`), but runs jitted, and
XLA folds a division by a constant into a product with its f32
reciprocal, which rounds differently in about 1 value in 20. The weight,
activation and KV quantizers and the int8 kernels (and their plain
versions) all multiply by `INV127`, so their scales are bitwise the JAX
package's as it runs.
"""
INV127 = 1.0 / 127.0
