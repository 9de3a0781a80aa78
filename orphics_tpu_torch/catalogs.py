"""Facade mirroring reference ``orphics.catalogs``."""
from .models.catalogs import (
    binned_map, healpix_binned_map, CatMapper, get_delta, get_delta_healpix,
    random_catalog_flat, get_random_catalog, Pow2Cat, split_samples,
    optimize_splits, select_based_on_mask, merge_duplicates, df_from_fits,
    load_fits, load_boss, BOSSMapper, HSCMapper, read_mangle_ply,
    hp_from_mangle, reconstruct_velocities)
from .models.catalogs import (filter_fits, fits_catalog_to_json, dndz,
                              select_region, enplot_annotate,
                              convert_hilton_catalog_to_enplot_annotate_file,
                              convert_fits_catalog_to_enplot_annotate_file,
                              convert_catalog_to_enplot_annotate_file)
