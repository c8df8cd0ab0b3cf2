"""The COCO captions dataset and its batched loader (counterpart of
show_tell_tpu/data/dataset.py, single process).

Reference semantics (utils.py:23-103), as the JAX package keeps them:
  * one sample per annotation (caption), not per image (utils.py:32);
  * JPEG -> RGB -> 224 x 224 on the host: the native libjpeg decoder
    (native/fastimage.py) with PIL for the files it rejects, or PIL alone
    where the decoder does not build (``MSCOCO.decoder`` says which);
  * captions lowercased and tokenized, wrapped in <start> ... <end>
    (utils.py:50-51);
  * a batch is sorted by descending caption length and zero-padded
    (utils.py:61-77); the train loader shuffles and drops the last partial
    batch, the test loader does neither (utils.py:92-99).

As in the JAX package, images leave the host as uint8 NHWC (the flips and
the normalization run on the device, in the train step), captions are
padded to a fixed ``pad_length`` with explicit lengths, and a background
thread loads batch k+1 while batch k trains.  The shuffle draws from
``numpy.random.RandomState(seed)`` exactly as the JAX loader does, so for
the same seed both yield the same batches in the same order.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from show_tell_tpu_torch.data.coco import CocoCaptions, FlickrCaptions
from show_tell_tpu_torch.data.images import IMAGE_SIZE
from show_tell_tpu_torch.native import fastimage
from show_tell_tpu_torch.vocab import word_tokenize

# Fixed caption pad length (the JAX package's): COCO train2014 captions
# tokenize to at most about 55 tokens with <start> and <end>.
DEFAULT_PAD_LENGTH = 64
PREFETCH = 2  # batches the loader's thread keeps ready

Batch = Tuple[Tuple[str, ...], np.ndarray, np.ndarray, np.ndarray]


def _pil_decode(full_path: str, fast_jpeg: bool) -> np.ndarray:
    """One image file -> uint8 [224, 224, 3] through PIL (with fast_jpeg,
    its DCT-domain draft mode for JPEGs), as the JAX package decodes it."""
    from PIL import Image

    with Image.open(full_path) as img:
        if fast_jpeg:
            img.draft("RGB", (IMAGE_SIZE, IMAGE_SIZE))  # no-op for non-JPEG
        return np.asarray(img.convert("RGB").resize((IMAGE_SIZE, IMAGE_SIZE), Image.BILINEAR), np.uint8)


class MSCOCO:
    """Annotation-keyed captions dataset (reference utils.py:23-59): COCO
    JSON, or a Flickr-style TSV for an ``ann_path`` ending in .tsv.
    ``tokenize`` splits a lowercased caption (nltk's ``word_tokenize`` by
    default); ``image_cache``: a directory for data/image_cache.ImageCache."""

    def __init__(
        self,
        ann_path: str,
        data_path: str,
        vocab,
        use_native_decode: Optional[bool] = None,
        fast_jpeg: bool = False,
        image_cache: Optional[str] = None,
        tokenize: Callable[[str], List[str]] = word_tokenize,
    ):
        self.data_path = data_path
        self.vocab = vocab
        self.use_native_decode = fastimage.is_available() if use_native_decode is None else use_native_decode
        self.fast_jpeg = fast_jpeg
        self.tokenize = tokenize
        coco = FlickrCaptions(ann_path) if ann_path.endswith(".tsv") else CocoCaptions(ann_path)
        self.annotation_ids = list(coco.anns.keys())
        self.annotation_obj = coco
        self.image_cache = None
        if image_cache:
            from show_tell_tpu_torch.data.image_cache import ImageCache

            names = [img["file_name"] for img in coco.imgs.values()]
            self.image_cache = ImageCache(image_cache, names, IMAGE_SIZE, fast_jpeg=fast_jpeg)

    @property
    def decoder(self) -> str:
        """Which JPEG decoder this dataset runs, and why."""
        if self.use_native_decode or not fastimage.is_available():
            return fastimage.status()
        return "PIL (use_native_decode=False)"

    def __len__(self) -> int:
        return len(self.annotation_ids)

    def caption_ids(self, sample_idx: int) -> List[int]:
        ann = self.annotation_obj.anns[self.annotation_ids[sample_idx]]
        v = self.vocab
        return [v("<start>")] + [v(t) for t in self.tokenize(str(ann["caption"]).lower())] + [v("<end>")]

    def sample_meta(self, sample_idx: int) -> Tuple[str, List[int]]:
        """(image file name, caption ids), without decoding the image."""
        ann = self.annotation_obj.anns[self.annotation_ids[sample_idx]]
        return self.annotation_obj.loadImgs(ann["image_id"])[0]["file_name"], self.caption_ids(sample_idx)

    def decode_image(self, image_path: str) -> np.ndarray:
        """An annotation-relative image file -> uint8 [224, 224, 3]."""
        full_path = os.path.join(self.data_path, image_path)
        if self.use_native_decode:
            with open(full_path, "rb") as f:
                batch, statuses = fastimage.decode_resize_batch([f.read()], IMAGE_SIZE, IMAGE_SIZE, n_threads=1,
                                                                fast_scale=self.fast_jpeg)
            if statuses[0] == 0:
                return batch[0]
        return _pil_decode(full_path, self.fast_jpeg)  # not a JPEG, damaged, or no native decoder

    def load_image(self, image_path: str) -> np.ndarray:
        """``decode_image`` through the image cache, where there is one."""
        if self.image_cache is None:
            return self.decode_image(image_path)
        img = self.image_cache.get(image_path)
        if img is None:
            img = self.decode_image(image_path)
            self.image_cache.put(image_path, img)
        return img

    def __getitem__(self, sample_idx: int) -> Tuple[str, np.ndarray, List[int]]:
        image_path, caption = self.sample_meta(sample_idx)
        return image_path, self.load_image(image_path), caption


def create_batch(samples: Sequence[Tuple[str, np.ndarray, List[int]]],
                 pad_length: Optional[int] = DEFAULT_PAD_LENGTH) -> Batch:
    """Collate samples (reference utils.py:61-77): stable sort by
    descending caption length, zero-pad to ``pad_length`` (the batch's
    longest when None; longer captions are cut).  Returns (paths, images
    uint8 [B,H,W,3], captions int32 [B,T], lengths int32 [B])."""
    order = sorted(range(len(samples)), key=lambda k: len(samples[k][2]), reverse=True)
    paths, images, captions = zip(*[samples[k] for k in order])
    lengths = np.array([min(len(c), pad_length) if pad_length else len(c) for c in captions], dtype=np.int32)
    target = np.zeros((len(captions), pad_length if pad_length else int(lengths.max())), dtype=np.int32)
    for i, cap in enumerate(captions):
        target[i, : lengths[i]] = cap[: lengths[i]]
    return paths, np.stack(images, 0), target, lengths


class DataLoader:
    """Batches of an MSCOCO dataset with shuffling, drop_last, and one
    background thread that loads the next batch (images decoded by
    ``num_workers`` threads)."""

    def __init__(self, dataset: MSCOCO, batch_size: int, shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 0, pad_length: int = DEFAULT_PAD_LENGTH, seed: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.pad_length = pad_length
        self._rng = np.random.RandomState(seed)
        self._pool: Optional[ThreadPoolExecutor] = None

    def close(self) -> None:
        """Release the decode pool (the loader stays usable)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> List[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        return [order[i * self.batch_size : (i + 1) * self.batch_size] for i in range(len(self))]

    def _load_batch(self, idxs: np.ndarray, pool: ThreadPoolExecutor) -> Batch:
        ds = self.dataset
        metas = [ds.sample_meta(int(i)) for i in idxs]
        if ds.use_native_decode and fastimage.is_available():
            images = self._decode_native([path for path, _ in metas], pool)
        else:
            images = list(pool.map(ds.load_image, [path for path, _ in metas]))
        return create_batch([(path, img, cap) for (path, cap), img in zip(metas, images)], self.pad_length)

    def _decode_native(self, paths: List[str], pool: ThreadPoolExecutor) -> List[np.ndarray]:
        """One threaded native call decodes the batch's uncached images;
        the files it rejects go through PIL one by one."""
        ds = self.dataset
        images: List[Optional[np.ndarray]] = [ds.image_cache.get(p) if ds.image_cache else None for p in paths]
        todo = [k for k, img in enumerate(images) if img is None]
        if todo:

            def read(path: str) -> bytes:
                with open(os.path.join(ds.data_path, path), "rb") as f:
                    return f.read()

            bufs = list(pool.map(read, [paths[k] for k in todo]))
            batch, statuses = fastimage.decode_resize_batch(bufs, IMAGE_SIZE, IMAGE_SIZE, n_threads=self.num_workers,
                                                            fast_scale=ds.fast_jpeg)
            for j, k in enumerate(todo):
                img = batch[j] if statuses[j] == 0 else _pil_decode(os.path.join(ds.data_path, paths[k]),
                                                                   ds.fast_jpeg)
                if ds.image_cache is not None:
                    ds.image_cache.put(paths[k], img)
                images[k] = img
        return images

    def __iter__(self) -> Iterator[Batch]:
        batches = self._batch_indices()
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        done = object()
        stop = threading.Event()
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        pool = self._pool

        def put(item) -> bool:
            while not stop.is_set():  # never block for good on a consumer that left
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # A load error reaches the consumer as an error, not as the end of the epoch.
            try:
                for idxs in batches:
                    if not put(self._load_batch(idxs, pool)):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                put(e)
                return
            finally:
                put(done)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)


def get_data_loader(vocab, params: Dict[str, Any], run_type: str) -> DataLoader:
    """The loader of reference utils.py:79-103 for run_type "train"
    (shuffled by ``params['seed']``, drop_last) or "test" (in order, every
    sample)."""
    if params.get("multihost"):
        raise NotImplementedError("multi-host loading (process-sharded batches) is ROADMAP Queue 1 item 6")
    cache_root = str(params.get("image_cache", "") or "")
    fast_jpeg = bool(params.get("fast_jpeg", 0))
    loader_kw = dict(batch_size=params["batch_size"], num_workers=params.get("num_workers", 0),
                     pad_length=params.get("pad_length", DEFAULT_PAD_LENGTH), seed=params.get("seed", 1))
    if run_type == "train":
        dataset = MSCOCO(params["ann_path_train"], params["data_path_train"], vocab, fast_jpeg=fast_jpeg,
                         image_cache=os.path.join(cache_root, "train") if cache_root else None)
        return DataLoader(dataset, shuffle=bool(params.get("shuffle", True)), drop_last=True, **loader_kw)
    if run_type == "test":
        dataset = MSCOCO(params["ann_path_test"], params["data_path_test"], vocab, fast_jpeg=fast_jpeg,
                         image_cache=os.path.join(cache_root, "test") if cache_root else None)
        return DataLoader(dataset, shuffle=False, drop_last=False, **loader_kw)
    raise ValueError("Please specify a valid run type for data loader. %s doesn't exist." % (run_type,))
