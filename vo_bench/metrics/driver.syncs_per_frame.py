"""driver.syncs_per_frame: host syncs that the entry points made over the
window (torch.cuda.set_sync_debug_mode flags), per frame."""


def read(run):
    if not run["frames"]:
        return None
    return run["syncs"] / run["frames"]
