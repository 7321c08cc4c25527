"""Device ms a decode step of the kernels launched under the int8 linears
(`layers.linear` on a `QuantLinear`, inside `engine._decode`): activation
quantization, the int8 GEMM, the rescale."""


def read(rec):
    steps = rec.counts.get("steps", 0)
    t = rec.range_device_s("bench.int8_linear.decode")
    return 1e3 * t / steps if steps and t else None
