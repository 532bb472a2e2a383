"""Float32 matmul policy of the port: full float32, no TF32.

The counterpart of the JAX package's ``Precision.HIGHEST``.  TF32 keeps about
three decimal digits, which would break the Newton-Schulz stopping tolerance
of 1e-4 and the accumulated normal terms.  Imported once, by the package.
The port never picks a device: every function works on the device of the
tensors it is given.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
