"""Elastic autoscaling: device inventory, endpoint templates,
device-second accounting, and the SLO-driven scaling loop that drives the
cluster's live attach/detach membership surface."""
from repro_torch.autoscale.inventory import (DeviceInventory, DeviceLedger,
                                       EndpointTemplate, UNIT_COST,
                                       build_endpoint, default_templates,
                                       endpoint_devices,
                                       heuristic_capacity_qps)
from repro_torch.autoscale.policy import (AutoscalePolicy, Autoscaler,
                                    parse_autoscale)

__all__ = [
    "AutoscalePolicy", "Autoscaler", "DeviceInventory", "DeviceLedger",
    "EndpointTemplate", "UNIT_COST", "build_endpoint", "default_templates",
    "endpoint_devices", "heuristic_capacity_qps", "parse_autoscale",
]
