"""Device ops with hand-written kernels.

Import by module path (``from flextree_tpu_torch.ops.paged_attention
import paged_attention``): the function shares its module's name, so the
package does not re-export it.
"""
