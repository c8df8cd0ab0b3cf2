"""Pure-Python COCO captions index (replaces the pycocotools C extension);
the port's own copy of show_tell_tpu/data/coco.py.

The reference builds ``pycocotools.coco.COCO`` over the captions JSON and
uses exactly three things (reference utils.py:32-42, vocab_builder.py:76-80):
  * ``coco.anns``        — dict annotation_id -> annotation record,
  * iteration order of ``coco.anns.keys()`` (drives vocab word ids),
  * ``coco.loadImgs(image_id)[0]['file_name']``.

pycocotools fills ``anns``/``imgs`` by iterating the JSON arrays in file
order into Python dicts, so insertion order == file order; ``json.load``
preserves that order too, which keeps downstream vocab ids bit-exact.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List


class CocoCaptions:
    """Minimal COCO captions API: anns / imgs / imgToAnns / loadImgs."""

    def __init__(self, annotation_file: str):
        with open(annotation_file, "r") as f:
            dataset = json.load(f)
        self.dataset = dataset
        self.anns: Dict[int, Dict[str, Any]] = {}
        self.imgs: Dict[int, Dict[str, Any]] = {}
        self.imgToAnns: Dict[int, List[Dict[str, Any]]] = {}
        for ann in dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.imgToAnns.setdefault(ann["image_id"], []).append(ann)
        for img in dataset.get("images", []):
            self.imgs[img["id"]] = img

    def loadImgs(self, ids) -> List[Dict[str, Any]]:
        if isinstance(ids, (list, tuple)):
            return [self.imgs[i] for i in ids]
        return [self.imgs[ids]]

    def getAnnIds(self, imgIds=None) -> List[int]:
        if imgIds is None:
            return list(self.anns.keys())
        if not isinstance(imgIds, (list, tuple)):
            imgIds = [imgIds]
        out: List[int] = []
        for img_id in imgIds:
            out.extend(a["id"] for a in self.imgToAnns.get(img_id, []))
        return out


def _csv_unquote(field: str) -> str:
    """pandas-compatible unquoting of ONE well-formed csv-quoted cell:
    a field that starts and ends with ``"`` with only doubled quotes
    inside is unwrapped and ``""`` -> ``"`` (the reference reads the
    Flickr TSV with pd.read_table, vocab_builder.py:84, which applies
    QUOTE_MINIMAL semantics — vocab ids must match on any file the
    reference can parse).  Anything else — notably an UNbalanced
    leading quote, on which the reference's pandas parse crashes
    outright — is kept raw (robustness beyond the reference)."""
    if len(field) >= 2 and field[0] == '"' and field[-1] == '"':
        inner = field[1:-1]
        if '"' not in inner.replace('""', ""):
            return inner.replace('""', '"')
    return field


def parse_flickr_tsv(annotation_file: str):
    """Yield (image_name, caption) rows from a Flickr-style TSV.

    Line-oriented ``split`` (a quoted caption never swallows later rows
    or embedded tabs, unlike a full csv parse), then pandas-compatible
    unquoting of well-formed quoted cells (see _csv_unquote).  Handles
    both the plain ``image<TAB>caption`` layout and the real Flickr30k
    token file's ``name.jpg#k<TAB>caption`` rows (the ``#k`` caption
    index is stripped from the image name)."""
    import re

    with open(annotation_file) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t", 1)
            if len(parts) < 2 or not parts[0]:
                continue
            yield re.sub(r"#\d+$", "", parts[0]), _csv_unquote(parts[1])


class FlickrCaptions(CocoCaptions):
    """Flickr30k-style captions index with the ``CocoCaptions`` surface
    (anns / imgs / imgToAnns / loadImgs inherited).

    The reference supports Flickr only in its vocabulary builder
    (vocab_builder.py:82-88 reads the TSV) and config block — its
    Dataset class is COCO-only and ``data_source`` is hardcoded
    (main.py:29).  This index finishes the job: rows become annotations
    in file order (one per caption, the same annotation-keyed semantics
    as COCO), unique image names become image records, so the whole
    pipeline — vocab ids included — works unchanged via
    ``--data_source Flickr``.
    """

    def __init__(self, annotation_file: str):
        self.anns = {}
        self.imgs = {}
        self.imgToAnns = {}
        image_ids: Dict[str, int] = {}
        for i, (name, caption) in enumerate(parse_flickr_tsv(annotation_file)):
            if name not in image_ids:
                image_ids[name] = len(image_ids)
                self.imgs[image_ids[name]] = {"id": image_ids[name], "file_name": name}
            ann = {"id": i, "image_id": image_ids[name], "caption": caption}
            self.anns[i] = ann
            self.imgToAnns.setdefault(ann["image_id"], []).append(ann)
