"""Running-average meters: the port's copy of `atmvfi_tpu/utils/
meters.py` (`AverageMeter`, `AverageMeterGroups`)."""
from __future__ import annotations


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class AverageMeterGroups:
    def __init__(self):
        self.meter_dict = {}

    def update(self, values: dict, n: int = 1):
        for name, val in values.items():
            if name not in self.meter_dict:
                self.meter_dict[name] = AverageMeter()
            self.meter_dict[name].update(val, n)

    def reset(self, name=None):
        if name is None:
            for meter in self.meter_dict.values():
                meter.reset()
        else:
            meter = self.meter_dict.get(name)
            if meter is not None:
                meter.reset()

    def avg(self, name):
        meter = self.meter_dict.get(name)
        return None if meter is None else meter.avg
