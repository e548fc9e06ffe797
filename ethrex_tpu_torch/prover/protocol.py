"""Proof-format names of the prover protocol.

The constants of `ethrex_tpu/prover/protocol.py` that the port's
`gpu_backend.prove_formats` needs; the values are the wire strings, so a
batch proof made by the port names its format as the reference's does.
"""

FORMAT_STARK = "stark"            # the batch STARKs as-is
FORMAT_COMPRESSED = "compressed"  # + recursion: FRI query work aggregated
#                                   into one outer STARK, path data dropped
FORMAT_GROTH16 = "groth16"        # compressed + BN254 MiMC wrap of the
#                                   aggregate digest (one pairing on L1)
FORMATS = (FORMAT_STARK, FORMAT_COMPRESSED, FORMAT_GROTH16)
