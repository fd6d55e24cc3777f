"""Configuration subsystem (port of ``cruise_control_tpu/config``): the
broker capacity resolvers. Broker sets and topic config providers come
with the slices that use them."""

from .capacity import (BrokerCapacityConfigResolver, BrokerCapacityInfo,
                       DEFAULT_CAPACITY, FileCapacityResolver,
                       FixedCapacityResolver)

__all__ = ["BrokerCapacityConfigResolver", "BrokerCapacityInfo",
           "DEFAULT_CAPACITY", "FileCapacityResolver", "FixedCapacityResolver"]
