"""Data model: Holder -> Index -> Field -> View -> Fragment, plus the Row
result algebra (the set- and int-field subset of pilosa_tpu.core)."""

from pilosa_tpu_torch.core.field import Field, FieldOptions
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.hostrow import HostRow
from pilosa_tpu_torch.core.index import Index, IndexOptions
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.view import View

__all__ = [
    "Field", "FieldOptions", "Fragment", "Holder", "HostRow", "Index",
    "IndexOptions", "Row", "View",
]
