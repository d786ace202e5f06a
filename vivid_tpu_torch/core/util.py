"""Paths, URLs and the download cache.

Counterpart of vivid_tpu/core/util.py (the reference's dnnlib.util
`open_url`): a local path or a file:// URL opens as it is; an HTTP(S) URL
resolves only from the cache, `<cache dir>/downloads/<md5 of the URL>_<file
name>` or `<cache dir>/downloads/<file name>`, since nothing here fetches
over the network; a miss raises FileNotFoundError naming the path to place
the file at. The cache dir is `set_cache_dir`'s, else $VIVID_CACHE_DIR,
else ~/.cache/vivid_tpu, the JAX package's, so one cache serves both.
"""

import hashlib
import os
import re
import urllib.parse
from typing import Optional

_cache_dir: Optional[str] = None


def set_cache_dir(path: Optional[str]):
    global _cache_dir
    _cache_dir = path


def make_cache_dir_path(*paths) -> str:
    """<cache dir>/<paths...>, made if missing."""
    base = _cache_dir or os.environ.get("VIVID_CACHE_DIR",
                                        os.path.expanduser("~/.cache/vivid_tpu"))
    path = os.path.join(base, *paths)
    os.makedirs(path, exist_ok=True)
    return path


def is_url(obj, allow_file_urls: bool = False) -> bool:
    """An http(s) URL with a host; with `allow_file_urls` a file:// URL too."""
    if not isinstance(obj, str) or "://" not in obj:
        return False
    if allow_file_urls and obj.startswith("file://"):
        return True
    try:
        res = urllib.parse.urlparse(obj)
    except ValueError:
        return False
    return bool(res.scheme in ("http", "https") and res.netloc)


def open_url(url: str, cache_dir: Optional[str] = None, cache: bool = True,
             verbose: bool = True, return_filename: bool = False):
    """A local path, a file:// URL or a cached HTTP(S) URL, opened for
    reading in binary (or its path, with `return_filename`)."""
    if url.startswith("file://"):
        url = urllib.parse.urlparse(url).path
    if not is_url(url):
        return url if return_filename else open(url, "rb")
    cache_root = cache_dir or make_cache_dir_path("downloads")
    url_md5 = hashlib.md5(url.encode("utf-8")).hexdigest()
    safe_name = re.sub(r"[^0-9a-zA-Z\-._]", "_", url.split("/")[-1]) or "download"
    path = os.path.join(cache_root, f"{url_md5}_{safe_name}")
    if cache and os.path.exists(path):
        if verbose:
            print(f"Using cached {path}")
        return path if return_filename else open(path, "rb")
    bare = os.path.join(cache_root, safe_name)   # a file placed in the cache by its name
    if os.path.exists(bare):
        return bare if return_filename else open(bare, "rb")
    raise FileNotFoundError(
        f"No network egress available to fetch {url!r}. Pre-seed the cache by "
        f"placing the file at {path} (or {bare}).")
