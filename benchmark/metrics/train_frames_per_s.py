"""Valid (unpadded) frames of every sample of the steps run in the window,
over the window, which ends on a device synchronise."""

UNIT = "frames/s"


def read(run):
    rec = run.record
    if rec["kind"] != "train" or not rec["steps"]:
        return None
    return float(sum(rec["lengths"])) / rec["window_s"]
