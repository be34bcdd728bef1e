"""repro_torch.cluster — network-replicated multi-node volume layer.

Lifts the single-box ``StripedVolume`` to a cluster: each member node
runs the full paper stack (transit cache over BTT over PMem, chained-tx
journal, group commit) behind a virtual-time network link, and the
cluster layer adds HDFS-style chunk placement, pipelined chain
replication, crc-ledger verified failover reads, heartbeat failure
detection and automatic re-replication.

    make_cluster(...)      — N-node cluster volume factory
    ClusterVolume          — the logical device (write/read/fsync +
                             submit/poll async surface, same as
                             StripedVolume)
    ClusterConfig          — geometry + policy knobs
    PlacementPolicy        — chunk -> chain mapping (ring / spread /
                             balanced; rack- and load-aware)
    NodeInfo               — static member topology description
    ClusterNode, NetLink   — one member volume behind a simulated link
    HeartbeatMonitor       — staleness-based failure suspicion
    ReReplicator           — dead-node detection + chunk regeneration
                             (cluster sibling of ReplicaResyncer)
    ClusterError and friends — delivery / availability failures
"""
from .cluster import ClusterConfig, ClusterVolume, ReReplicator, make_cluster
from .node import (ClusterError, ClusterNode, ClusterUnavailableError,
                   HeartbeatMonitor, NetLink, NetworkPartitionError,
                   NodeDownError)
from .placement import POLICIES, NodeInfo, PlacementPolicy

__all__ = [
    "ClusterConfig", "ClusterVolume", "ReReplicator", "make_cluster",
    "ClusterError", "ClusterNode", "ClusterUnavailableError",
    "HeartbeatMonitor", "NetLink", "NetworkPartitionError",
    "NodeDownError", "POLICIES", "NodeInfo", "PlacementPolicy",
]
