// Native HEALPix RING pixelization math for orphics_tpu_torch (the JAX
// package's csrc/healpix.cpp, its functions taking z = cos(theta) in place
// of theta; a host library, not a GPU kernel).
//
// Replaces the healpy (C++ HEALPix) dependency of the reference
// (orphics/catalogs.py: ang2pix-based map-making; orphics/maps.py healpix
// helpers) for the catalog -> map hot path: batched ang2pix/pix2ang over
// millions of sources, OpenMP-threaded. Built with g++ at first use by
// orphics_tpu_torch/_build.py:healpix_library and loaded through ctypes
// (orphics_tpu_torch/utils/healpix.py), with a numpy fallback where it
// does not build.
//
// Algorithms follow the HEALPix primer (Gorski et al. 2005).

#include <cmath>
#include <cstdint>

extern "C" {

static const double PI = 3.14159265358979323846;

// z = cos(colatitude), phi (rad) -> RING pixel index
static int64_t ang2pix_z(long nside, double z, double phi) {
    double za = std::fabs(z);
    double tt = std::fmod(phi / (0.5 * PI), 4.0);
    if (tt < 0) tt += 4.0;
    int64_t npix = 12L * nside * nside;
    int64_t p;
    if (za <= 2.0 / 3.0) {
        double temp1 = nside * (0.5 + tt);
        double temp2 = nside * z * 0.75;
        int64_t jp = (int64_t)std::floor(temp1 - temp2);
        int64_t jm = (int64_t)std::floor(temp1 + temp2);
        int64_t ir = nside + 1 + jp - jm;  // ring counted from z=2/3
        int64_t kshift = 1 - (ir & 1);
        int64_t nl4 = 4 * nside;
        int64_t ip = (int64_t)std::floor((jp + jm - nside + kshift + 1) / 2.0);
        ip = ((ip % nl4) + nl4) % nl4;
        p = 2 * nside * (nside - 1) + (ir - 1) * nl4 + ip;
    } else {
        double tp = tt - std::floor(tt);
        double tmp = nside * std::sqrt(3.0 * (1.0 - za));
        int64_t jp = (int64_t)std::floor(tp * tmp);
        int64_t jm = (int64_t)std::floor((1.0 - tp) * tmp);
        int64_t ir = jp + jm + 1;
        int64_t ip = (int64_t)std::floor(tt * ir);
        ip = ((ip % (4 * ir)) + 4 * ir) % (4 * ir);
        if (z > 0)
            p = 2 * ir * (ir - 1) + ip;
        else
            p = npix - 2 * ir * (ir + 1) + ip;
    }
    return p;
}

// z = cos(theta), phi (rad) -> RING pixel index. The caller takes the
// cosine, and the arccos of pix2z_ring's z: numpy's float64 cos and arccos
// may round otherwise than libm's, and with numpy's on both paths the
// native results equal the numpy code's exactly. (The JAX package's
// library takes theta: ang2pix_ring / pix2ang_ring.)
void ang2pix_ring_z(long nside, const double* z, const double* phi,
                    int64_t* pix, long n) {
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; ++i) pix[i] = ang2pix_z(nside, z[i], phi[i]);
}

// RING pixel index -> (z = cos(theta), phi) at the pixel's center
static void pix2z(long nside, int64_t p, double& z, double& ph) {
    int64_t npix = 12L * nside * nside;
    int64_t ncap = 2L * nside * (nside - 1);
    if (p < ncap) {  // north polar cap
        int64_t iring = (int64_t)(0.5 * (1 + std::sqrt(1.0 + 2.0 * p)));
        if (2 * iring * (iring - 1) > p) iring -= 1;
        if (2 * iring * (iring + 1) <= p) iring += 1;
        int64_t iphi = p - 2 * iring * (iring - 1) + 1;
        z = 1.0 - (iring * (double)iring) / (3.0 * nside * nside);
        ph = (iphi - 0.5) * PI / (2.0 * iring);
    } else if (p < npix - ncap) {  // equatorial belt
        int64_t ip = p - ncap;
        int64_t nl4 = 4 * nside;
        int64_t iring = ip / nl4 + nside;
        int64_t iphi = ip % nl4 + 1;
        double fodd = ((iring + nside) & 1) ? 1.0 : 0.5;
        z = (2.0 * nside - iring) * 2.0 / (3.0 * nside);
        ph = (iphi - fodd) * PI / (2.0 * nside);
    } else {  // south polar cap
        int64_t ip = npix - p;
        int64_t iring = (int64_t)(0.5 * (1 + std::sqrt(2.0 * ip - 1.0)));
        if (2 * iring * (iring + 1) >= ip) {
            // iring too big
            while (iring > 1 && 2 * iring * (iring - 1) >= ip) iring -= 1;
        } else {
            while (2 * iring * (iring + 1) < ip) iring += 1;
        }
        int64_t iphi = 4 * iring + 1 - (ip - 2 * iring * (iring - 1));
        z = -1.0 + (iring * (double)iring) / (3.0 * nside * nside);
        ph = (iphi - 0.5) * PI / (2.0 * iring);
    }
}

// RING pixel index -> (z = cos(theta), phi) at pixel centers (the caller
// takes the arccos; see ang2pix_ring_z)
void pix2z_ring(long nside, const int64_t* pix, double* z, double* phi,
                long n) {
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; ++i) pix2z(nside, pix[i], z[i], phi[i]);
}

}  // extern "C"
