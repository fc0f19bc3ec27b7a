"""Dataset registry (own copy of ``siammot_tpu.data.dataset_info``).

Key -> (dataset folder, annotation file, split file / image folder,
modality), the reference's table, so its dataset keys work unchanged.
"""

dataset_maps = {
    # synthetic MOT-format benchmark rendered by tools/make_synth_mot.py
    # (stands in for MOT17/CrowdHuman, which cannot ship with the repo)
    "SYNMOT": ["SYNMOT", "anno.json", "splits.json", "video"],
    # hard preset (MOT17 statistics: crowding, pan/zoom camera, amodal
    # truncation, long occlusions, simulated public detections) rendered
    # by tools/make_synth_mot.py --preset hard
    "SYNMOT_HARD": ["SYNMOT_HARD", "anno.json", "splits.json", "video"],
    # one 16-frame SYNMOT_HARD test sequence committed to the repo
    # (tests/fixtures/synmot_mini, DATASETS.ROOT_DIR tests/fixtures)
    "SYNMOT_MINI": ["synmot_mini", "anno.json", "splits.json", "video"],
    # CrowdHuman-style crowded stills (tools/make_synth_crowd.py) for
    # detector pretraining, mirroring the reference's CrowdHuman fbox keys
    "SYNCROWD_train_fbox": ["SYNCROWD",
                            "annotations/annotation_train_fbox.json",
                            "Images", "image"],
    "SYNCROWD_val_fbox": ["SYNCROWD",
                          "annotations/annotation_val_fbox.json",
                          "Images", "image"],
    "TAO": ["TAO", "anno_person.json", "splits_person.json", "video"],
    "CRP": ["caltech_roadside_pedestrians", "anno.json", "splits.json",
            "video"],
    "MOT17_DPM": ["MOT17", "anno.json", "splits_DPM.json", "video"],
    "MOT17": ["MOT17", "anno.json", "splits.json", "video"],
    "AOT": ["airbone_object_tracking", "anno.json", "splits.json", "video"],
    "COCO17_train": ["mscoco", "annotations/MSCOCO2017_train_person.json",
                     "images/train2017", "image"],
    "crowdhuman_train_fbox": ["CrowdHuman",
                              "annotations/annotation_train_fbox.json",
                              "Images", "image"],
    "crowdhuman_train_vbox": ["CrowdHuman",
                              "annotations/annotation_train_vbox.json",
                              "Images", "image"],
    "crowdhuman_val_fbox": ["CrowdHuman",
                            "annotations/annotation_val_fbox.json",
                            "Images", "image"],
    "crowdhuman_val_vbox": ["CrowdHuman",
                            "annotations/annotation_val_vbox.json",
                            "Images", "image"],
}
