"""Backend and proof-format names of the prover protocol.

The constants of `ethrex_tpu/prover/protocol.py` that the port's backends
need; the values are the wire strings, so a batch proof made by the port
names its backend and format as the reference's does.
"""

PROVER_EXEC = "exec"
PROVER_TPU = "tpu"   # the STARK prover's wire name, whatever its device

FORMAT_STARK = "stark"            # the batch STARKs as-is
FORMAT_COMPRESSED = "compressed"  # + recursion: FRI query work aggregated
#                                   into one outer STARK, path data dropped
FORMAT_GROTH16 = "groth16"        # compressed + BN254 MiMC wrap of the
#                                   aggregate digest (one pairing on L1)
FORMATS = (FORMAT_STARK, FORMAT_COMPRESSED, FORMAT_GROTH16)
