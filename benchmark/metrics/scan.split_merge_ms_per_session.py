"""Host instance split (`split_into_instances_by_radius`, native radius
components) and the OBB merge (`merge_bb`): "split" + "merge" of
`FastSegmentation.stage_seconds`, mean over the window's sessions."""


def read(rec):
    ms = [1e3 * (r["stages"]["split"] + r["stages"]["merge"]) for r in rec["requests"]
          if "split" in r["stages"] and "merge" in r["stages"]]
    return sum(ms) / len(ms) if ms else None
