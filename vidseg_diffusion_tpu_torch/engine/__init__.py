"""The VidSeg engine: harvest pass, masks, modulated runs, segmentation."""
