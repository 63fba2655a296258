"""V-ETL Load: the columnar store, single or stream-hash sharded (on a
stacked shard axis on one device, or over a ``torch.distributed`` group
of ranks, one a card: ``launch.mesh``), its queries, its standing
queries, its int8 cold tier and its checkpoints (see store.py /
query.py / standing.py / tiers.py)."""
from repro_torch.warehouse.query import (Filter, GroupBy, MultiGroupBy,
                                         Project, TopK, WindowAgg, execute,
                                         execute_ref, execute_sharded,
                                         to_host, windows_for)
from repro_torch.warehouse.standing import Alert, StandingQueries
from repro_torch.warehouse.store import SegmentStore, ShardedStore
from repro_torch.warehouse.tiers import (ShardedTieredStore, TieredStore,
                                         load_warehouse, save_warehouse)

__all__ = [
    "SegmentStore", "ShardedStore", "TieredStore", "ShardedTieredStore",
    "StandingQueries", "Alert",
    "Filter", "Project", "GroupBy", "WindowAgg", "MultiGroupBy", "TopK",
    "execute", "execute_sharded", "execute_ref", "to_host",
    "windows_for", "save_warehouse", "load_warehouse",
]
