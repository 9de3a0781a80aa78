"""Facade mirroring reference ``orphics.pixcov`` (port of
``orphics_tpu.pixcov``)."""
from .models.pixcov import (
    ps2d_to_mat, rotate_pol_power, stamp_pixcov_from_theory,
    scov_from_theory, ncov_ivar_diag, get_geometry_regions, make_geometry,
    make_geometries_batched, inpaint_stamp, inpaint_stamps_batched,
    extract_stamps, insert_stamps, inpaint, save_geometries, load_geometries)

# reference naming
inpaint_uncorrelated_save_geometries = save_geometries
inpaint_uncorrelated_from_saved_geometries = inpaint_stamps_batched
extract_cutouts = extract_stamps
from .models.pixcov import (map_ifft, corrfun_thumb, corr_to_mat, resolution,
                            fcov_to_rcorr, ncov_from_ivar, pcov_from_ivar,
                            tpcov_from_ivar, paste, cinv_inpaint, get_regions,
                            preload_geometries)
