"""Conformer batches and split Fock builds (port of ``nbed_tpu/parallel``).

The reference's parallel dimensions, in torch:

- **data parallel**: a lane axis over conformer batches (every integral and
  the SCF take (B, natm, 3) coordinates; each SCF cycle of a batch is one
  fused J/K launch), the lanes split in groups over a mesh's 'batch' axis;
- **model parallel**: the ERI supermatrices split in row slabs, the DF
  factor over its auxiliary axis and the XC grid over its points, over a
  mesh's 'model' axis, with the gather and the sums written out in one
  process (no GSPMD, no ``torch.distributed``).
"""

from .embed_path import batched_embedding_energies, make_mu_embed_energy
from .sharding import (
    batched_hf_energies,
    batched_hf_gradients,
    make_mesh,
    make_sharded_df_ks,
    make_sharded_df_scf,
    make_sharded_scf,
    sharded_df_ks,
    sharded_df_scf,
    sharded_scf,
)

__all__ = ["make_mesh", "make_sharded_scf", "sharded_scf", "make_sharded_df_scf",
           "sharded_df_scf", "make_sharded_df_ks", "sharded_df_ks",
           "batched_hf_energies", "batched_hf_gradients",
           "make_mu_embed_energy", "batched_embedding_energies"]
