"""mask_dets.fpn: detections a request sends through the mask head (those
the class step keeps: threshold, per-class NMS, the cap of 100), the mean
over the window's images, read from the driver's kept outputs."""


def read(run):
    return run.driver.mask_dets() if run.driver.kept else None
