"""Image file discovery (port of `vit_ad_tpu/data/files.py`: the extensions
the reference's join_to_file_list collects, GeneralDataLoader.py:61-65)."""

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".tiff", ".bmp")
