"""Configuration subsystem (port of ``cruise_control_tpu/config``): the
broker capacity resolvers and the broker-set resolution behind
``BrokerSetAwareGoal``. Topic config providers come with the slice that
uses them."""

from .brokersets import (FileBrokerSetResolver, StaticBrokerSetResolver,
                         topic_set_array)
from .capacity import (BrokerCapacityConfigResolver, BrokerCapacityInfo,
                       DEFAULT_CAPACITY, FileCapacityResolver,
                       FixedCapacityResolver)

__all__ = ["BrokerCapacityConfigResolver", "BrokerCapacityInfo",
           "DEFAULT_CAPACITY", "FileBrokerSetResolver", "FileCapacityResolver",
           "FixedCapacityResolver", "StaticBrokerSetResolver",
           "topic_set_array"]
