"""Streaming substrate: declarative API, benchmark apps, simulators, runtime.

Preferred entry point::

    from repro_torch.streaming import Job, Topology
    plan = Job(topology).plan(machine, optimizer="rlas")
    plan.estimate(); plan.simulate(); plan.execute()
"""
from .api import (Job, Metrics, Plan, StreamingApp, Topology, TopologyError)
from .routing import (PARTITION_STRATEGIES, Route, RouteSpec, RoutingTable,
                      WatermarkMerger, compile_routes, extract_event_times)
from .state import (BroadcastTable, EventTimeWindowState, KeyedStore,
                    OperatorState, PaneBatch, PaneSegments, StateSpec,
                    UndeclaredStateError, ValueStore, WindowSpec,
                    WindowState, gather_segments, grid_pane_ends,
                    merge_keyed, migrate_states, pane_range,
                    repartition_keyed, segmented)

__all__ = ["Job", "Metrics", "Plan", "StreamingApp", "Topology",
           "TopologyError", "PARTITION_STRATEGIES", "Route", "RouteSpec",
           "RoutingTable", "WatermarkMerger", "compile_routes",
           "extract_event_times",
           "BroadcastTable", "EventTimeWindowState", "KeyedStore",
           "OperatorState", "PaneBatch", "PaneSegments", "StateSpec",
           "UndeclaredStateError", "ValueStore", "WindowSpec",
           "WindowState", "gather_segments", "grid_pane_ends",
           "merge_keyed", "migrate_states", "pane_range",
           "repartition_keyed", "segmented"]
