"""bag_pad_share.train: the share of the id slots the traced steps' gathers,
K1 and scatters read that hold no id their lookups pool, in percent:
100 (1 - bag_ids / bag_slots), from the graphed step's counters over the
traced stretch. None where the program has no such counters."""


def read(record):
    traced = record.get("traced")
    bags = traced.get("bags") if traced else None
    if not bags or not bags["bag_slots"]:
        return None
    return 100.0 * (1.0 - bags["bag_ids"] / bags["bag_slots"])
