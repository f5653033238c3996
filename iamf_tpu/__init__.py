"""iamf-tpu: IAMF decode + rendering framework on an accelerator (JAX/XLA).

Precision policy: this is a *decoder* with bit-exactness guarantees
(FLAC/PCM lossless paths must match the reference player byte-for-byte,
lossy paths carry SNR bars). On an NVIDIA GPU, XLA may evaluate a float32
contraction in TF32 on the tensor cores (10 explicit mantissa bits, about
three decimal digits), which silently breaks those guarantees on the card
while CPU tests still pass. Every contraction in the decode graph therefore
passes ``precision=jax.lax.Precision.HIGHEST`` (IEEE float32) explicitly
at its call site (render einsums, IMDCT/filterbank matmuls, HRTF
frequency-domain mixes, the true-peak meter) rather than flipping the
process-global ``jax_default_matmul_precision`` flag, which would silently
change the numerics and performance of other JAX code sharing the process.
"""
