"""V-ETL Load on one device: the columnar store and its queries (see
store.py / query.py)."""
from repro_torch.warehouse.query import (Filter, GroupBy, MultiGroupBy,
                                         Project, TopK, WindowAgg, execute,
                                         to_host, windows_for)
from repro_torch.warehouse.store import SegmentStore

__all__ = [
    "SegmentStore", "Filter", "Project", "GroupBy", "WindowAgg",
    "MultiGroupBy", "TopK", "execute", "to_host", "windows_for",
]
