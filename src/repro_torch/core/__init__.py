"""repro_torch.core — the paper's contribution: I/O transit caching (Caiti) over a
PMem block device with block-level write atomicity (BTT).

Public API:
    make_device(policy, ...)      — full device stacks ('caiti', 'btt', 'lru', ...)
    BTT, PMemSpace, LatencyModel  — substrate pieces
    CaitiCache, CaitiConfig       — the transit cache itself
    TransitBuffer                 — Caiti's policies for arbitrary sinks (ckpt engine)
    Bio, BioFlags, fsync_bio      — block-I/O request model
"""
from .bio import Bio, BioFlags, BioOp, SUCCESS, EIO, fsync_bio, preflush_bio
from .btt import BTT
from .cache import CaitiCache, CaitiConfig, FREE, PENDING, VALID, EVICTING
from .device import BlockDevice, make_device, POLICIES
from .metrics import Metrics, ShardScorer, CATEGORIES
from .pmem import PMemSpace, LatencyModel, NO_LATENCY, SimulatedCrash
from .policies import CoActiveCache, LRUCache, PMBD70Cache, PMBDCache
from .transit import TransitBuffer

__all__ = [
    "Bio", "BioFlags", "BioOp", "SUCCESS", "EIO", "fsync_bio", "preflush_bio",
    "BTT", "CaitiCache", "CaitiConfig", "FREE", "PENDING", "VALID", "EVICTING",
    "BlockDevice", "make_device", "POLICIES", "Metrics", "ShardScorer",
    "CATEGORIES",
    "PMemSpace", "LatencyModel", "NO_LATENCY", "SimulatedCrash",
    "CoActiveCache", "LRUCache", "PMBD70Cache", "PMBDCache", "TransitBuffer",
]
