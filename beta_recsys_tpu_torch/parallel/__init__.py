"""Row-sharded embedding tables on a device mesh (counterpart of
``beta_recsys_tpu/parallel/``: ``mesh.py`` and ``embedding.py``)."""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh"]
