"""V-ETL Load on one device: the columnar store, its queries, its
standing queries and its int8 cold tier (see store.py / query.py /
standing.py / tiers.py)."""
from repro_torch.warehouse.query import (Filter, GroupBy, MultiGroupBy,
                                         Project, TopK, WindowAgg, execute,
                                         to_host, windows_for)
from repro_torch.warehouse.standing import Alert, StandingQueries
from repro_torch.warehouse.store import SegmentStore
from repro_torch.warehouse.tiers import TieredStore

__all__ = [
    "SegmentStore", "Filter", "Project", "GroupBy", "WindowAgg",
    "MultiGroupBy", "TopK", "execute", "to_host", "windows_for",
    "StandingQueries", "Alert", "TieredStore",
]
